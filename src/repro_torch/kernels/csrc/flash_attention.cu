// Flash attention (forward) for Hopper (sm_90a): bfloat16 on the tensor
// cores, float32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (body `_flash_kernel`):
//
//     O[b, h] = softmax(Q[b, h] K[b, h / G]^T / sqrt(D)) V[b, h / G]
//
// q [B, H, Sq, D], k/v [B, Hkv, Skv, D], G = H / Hkv (grouped-query; MQA is
// Hkv = 1), float32 or bfloat16 in, the same dtype out.  Scores, the
// online-softmax state (m, l) and the output accumulator are float32.  With
// `causal`, key j is visible to query i when j <= i (aligned at position 0,
// as the plain version `flash_attention_ref` aligns Sq != Skv).  Keys at or
// past Skv are masked in every mode: the JAX kernel masked its zero padding
// only under `causal`.  A row that has seen no visible key keeps p = 0.  For
// bfloat16 the probabilities are rounded to bfloat16 before the P·V product,
// as the JAX kernel does; the running sum l adds the unrounded ones.  The
// output is acc / max(l, 1e-30).  The TPU kernel walked the key tiles as the
// innermost, sequential grid axis with (m, l, acc) in VMEM scratch; Hopper
// blocks run in parallel and in no order, so here one block owns one
// (b, h, query tile) and loops over the key tiles itself.  Query head h
// reads kv head h / G in place: k and v are never repeated G times.  Every
// tensor is addressed through (batch, head, sequence) strides with a
// contiguous last dim, so the model layout [B, S, H, D] is read and written
// without a transpose.  The ragged ends of Sq, Skv and D are masked on load
// and on store; nothing is padded in device memory.  D <= 256.
//
// Bound.  Bytes: q, k and v read once, o written once:
// (2·B·H·Sq + 2·B·Hkv·Skv)·D·itemsize.  Operations: 4·D per visible
// (query, key) pair, about 4·B·H·Sq·Skv·D / 2 when causal.  At the serving
// prompt group [2, 512, 10 x 256] in bfloat16 that is 11.5 MB and 2.68 GFLOP:
// 3.4 µs at 3.35 TB/s, 2.7 µs at the 989 TFLOP/s bf16 tensor-core peak, so
// the card's bound is set by bytes.
//
// bfloat16: `flash_bf16_kernel`, FlashAttention-2 style on mma.sync.
//   - 8 warps.  A query tile of BQ = 64 rows is 4 query warps of 16 rows in
//     each of two key groups: group 0 takes key tiles 0, 2, 4, ... and
//     group 1 tiles 1, 3, 5, ..., each with its own online softmax, and the
//     two (m, l, acc) are merged at the end.  So an SM runs 8 warps on a
//     tile's keys even when the grid has about one block per SM, and a
//     causal tile's chain of key tiles is halved.  Key tiles are 64 rows.
//     One key group of 4 warps (96 KB at D = 256, two blocks an SM) and a
//     128-row tile of 8 query warps in one group both measured slower
//     (PERF.md).
//   - Q, K and V live in shared memory as bfloat16 rows of DP = D padded to
//     16, 32, 64, 128 or 256 columns (the padding zero-filled), with a
//     16-byte XOR swizzle so that every ldmatrix reads 8 distinct bank
//     groups.  Q is loaded once; each key group has a K and a V buffer, and
//     cp.async keeps one load in flight: V's tile loads while Q·K^T runs,
//     the group's next K tile while P·V runs.  A group's warps meet at their
//     own named barrier.  At D = 256 that is 160 KB.
//   - S = Q·K^T with m16n8k16 from ldmatrix fragments, all of a 16-column
//     step's fragments loaded before its products; the 16 x 64 scores of a
//     warp stay in registers (32 floats a thread).
//   - The online softmax runs in registers: a row's max takes two
//     __shfl_xor steps inside its quad; each thread keeps partial row sums,
//     reduced over the quad once at the end.
//   - P·V: p is rounded to bfloat16 in registers and used as the A fragment
//     directly (two adjacent m16n8 accumulator fragments have the layout of
//     one m16n8k16 A fragment); V comes through ldmatrix.trans.  The 16 x DP
//     output accumulator of a warp stays in registers.
//   - Causal: key tiles above the diagonal are never visited, a warp whose
//     rows all lie above a key tile skips it, and only the diagonal and the
//     ragged last tile are masked.  Query tiles launch heaviest first.
//   What still bounds it: at D = 256 a warp's accumulator and scores take
//   the registers (255 a thread), so no more warps fit an SM and the
//   fragment loads are not pipelined ahead of the products; mma.sync
//   reaches part of the rate of Hopper's wgmma; a block re-reads K and V
//   from L2.
//
// float32: `flash_fwd_kernel`, on CUDA cores (TF32 would miss the f32
//   tolerance).  One block of 256 threads owns BQ query rows and loops over
//   key tiles of BK = BQ rows.  Per key tile:
//   1. K's tile is staged in shared memory (rows past Skv and columns past D
//      are zeros).  The Q tile was staged once.  Both have an odd row pitch,
//      so the 16 threads of a half-warp, reading 16 rows at one column, hit
//      16 distinct banks.
//   2. S = Q K^T: thread (tx, ty) keeps a (BQ/16) x (BK/16) register tile
//      (rows ty·BQ/16 + i, columns tx + 16·j) and accumulates it with fp32
//      FMAs over D.  Scaled, masked scores go to a key-major P tile.
//   3. Online softmax, one warp per query row, lanes along the keys.
//   4. V's tile replaces K's in the same buffer, and each thread rescales
//      and accumulates its (BQ/16) x CN output tile from P and V.
//   D is padded to a register tile of 16·CN columns (CN = 1, 2, 4, 8 or 16).
//   Square tiles BQ = BK in {32, 64, 128} that fit the 227 KB of shared
//   memory a block may use.  It runs at 67 TFLOP/s peak at best, with
//   shared-memory operands, far from either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // in elements; the head dim is contiguous
};

// ------------------------------------------------------ float32, CUDA cores

constexpr int kThreads = 256;
constexpr int kTX = 16;  // threads along keys (scores) and head dim (output)
constexpr int kTY = 16;  // threads along queries

constexpr long long smem_floats(int bq, int bk, int cn) {
  return static_cast<long long>(bq) * (kTX * cn + 1) +  // Q tile
         static_cast<long long>(bk) * (kTX * cn + 1) +  // K, then V, tile
         static_cast<long long>(bk) * (bq + 1) +        // P tile, key-major
         3LL * bq;                                      // m, l, correction
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int BQ, int BK, int CN>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides sq, Strides sk, Strides sv, Strides so, int group,
                 int len_q, int len_kv, int dim, float scale, int causal) {
  constexpr int DP = kTX * CN;  // head dim padded to the register tile
  constexpr int LD = DP + 1;    // odd pitch of the Q and K/V tiles
  constexpr int LP = BQ + 1;    // odd pitch of the key-major P tile
  constexpr int RN = BQ / kTY;  // query rows per thread
  constexpr int SC = BK / kTX;  // score columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][LD]
  float* kvs = qs + BQ * LD;   // [BK][LD]
  float* ps = kvs + BK * LD;   // [BK][LP]
  float* m_s = ps + BK * LP;   // [BQ]
  float* l_s = m_s + BQ;       // [BQ]
  float* c_s = l_s + BQ;       // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const long long h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const long long qb = b * sq.b + h * sq.h, ob = b * so.b + h * so.h;
  const long long kb = b * sk.b + hk * sk.h, vb = b * sv.b + hk * sv.h;

  for (int i = tid; i < BQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    qs[r * LD + d] = (q0 + r < len_q && d < dim) ? q[qb + (q0 + r) * sq.s + d] : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[RN][CN];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  const int q_end = min(q0 + BQ, len_q);
  const int kv_end = causal ? min(len_kv, q_end) : len_kv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's P·V is done with kvs and ps
    for (int i = tid; i < BK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      kvs[r * LD + d] = (k0 + r < len_kv && d < dim) ? k[kb + (k0 + r) * sk.s + d] : 0.f;
    }
    __syncthreads();

    float s[RN][SC];
#pragma unroll
    for (int i = 0; i < RN; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dim; ++d) {
      float a[RN], c[SC];
#pragma unroll
      for (int i = 0; i < RN; ++i) a[i] = qs[(ty * RN + i) * LD + d];
#pragma unroll
      for (int j = 0; j < SC; ++j) c[j] = kvs[(tx + kTX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const int qp = q0 + ty * RN + i;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kp = k0 + tx + kTX * j;
        const bool seen = kp < len_kv && (!causal || kp <= qp);
        ps[(tx + kTX * j) * LP + ty * RN + i] = seen ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    for (int r = warp; r < BQ; r += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, ps[c * LP + r]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      const bool live = m_new > 0.5f * kNegInf;  // a visible key was seen
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = live ? expf(ps[c * LP + r] - m_new) : 0.f;
        sum += p;
        ps[c * LP + r] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    for (int i = tid; i < BK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      kvs[r * LD + d] = (k0 + r < len_kv && d < dim) ? v[vb + (k0 + r) * sv.s + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const float corr = c_s[ty * RN + i];
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] *= corr;
    }
    const int kn = min(BK, kv_end - k0);  // keys past kv_end have p = 0
    for (int c = 0; c < kn; ++c) {
      float p[RN], w[CN];
#pragma unroll
      for (int i = 0; i < RN; ++i) p[i] = ps[c * LP + ty * RN + i];
#pragma unroll
      for (int j = 0; j < CN; ++j) w[j] = kvs[c * LD + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int r = ty * RN + i;
    if (q0 + r >= len_q) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    const long long row = ob + (q0 + r) * so.s;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int d = tx + kTX * j;
      if (d < dim) o[row + d] = acc[i][j] / den;
    }
  }
}

// ------------------------------------------------- bfloat16, tensor cores

constexpr int kBK16 = 64;                     // keys per tile
constexpr int kQW = 4;                        // query warps of 16 rows: 64 rows
constexpr int kKG = 2;                        // key groups over alternate key tiles
constexpr float kLog2e = 1.4426950408889634f;

// The 16-byte XOR swizzle of a [rows][DP] bf16 tile: chunk c of row r is
// stored at chunk c ^ key(r), key(r) the row's position in its 128 bytes of
// rows, so the 8 rows an ldmatrix matrix reads (consecutive rows, one chunk
// column) land on 8 distinct 16-byte bank groups.  key(r) depends on r % 8
// only.
template <int DP>
__device__ __forceinline__ int swz_key(int r) {
  constexpr int NC = DP / 8;                  // chunks per row
  constexpr int M = NC < 8 ? NC : 8;          // XOR range
  constexpr int R = NC < 8 ? 8 / NC : 1;      // rows per 128 bytes
  return ((r & 7) / R) % M;
}

// Element offset, within its row, of chunk c of a row whose key is x.
__device__ __forceinline__ int swz_col(int c, int x) {
  return ((c & ~7) | ((c & 7) ^ x)) << 3;
}

// Element offset of chunk c of row r.
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DP + swz_col(c, swz_key<DP>(r));
}

// Stage rows [s0, s0 + ROWS) of one head (`g`, row stride `rs` elements)
// into the swizzled tile `t`; rows at or past `len` and columns at or past
// `dim` are zeros.  `vec` (16-byte aligned rows, dim % 8 == 0): cp.async
// copies of 16 bytes, in flight until the caller waits.  Otherwise plain
// element loads, done when this returns.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* t, const __nv_bfloat16* g,
                                          long long rs, int s0, int len, int dim,
                                          bool vec, int tid) {
  constexpr int NC = DP / 8;
  if (vec) {
#pragma unroll 4
    for (int i = tid; i < ROWS * NC; i += THREADS) {
      const int r = i / NC, c = i % NC;
      const bool ok = s0 + r < len && c * 8 < dim;
      mma::cp_async_16(mma::smem_addr(t + swz<DP>(r, c)),
                       ok ? g + (s0 + r) * rs + c * 8 : g, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, d = i % DP;
      t[swz<DP>(r, d >> 3) + (d & 7)] = (s0 + r < len && d < dim)
                                            ? g[(s0 + r) * rs + d]
                                            : __float2bfloat16_rn(0.f);
    }
  }
}

// Barrier over the GT threads of key group `grp` (0 or 1): named barriers
// 1 and 2, as immediates, so that the block holds three barriers (0 is
// __syncthreads).
template <int GT>
__device__ __forceinline__ void group_sync(int grp) {
  if (grp == 0)
    asm volatile("bar.sync 1, %0;\n" :: "n"(GT) : "memory");
  else
    asm volatile("bar.sync 2, %0;\n" :: "n"(GT) : "memory");
}

template <int DP>
__global__ void __launch_bounds__(kQW * kKG * 32)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  Strides sq, Strides sk, Strides sv, Strides so, int group,
                  int len_q, int len_kv, int dim, float scale_log2, int causal,
                  int vec, int ovec) {
  constexpr int QW = kQW, KG = kKG;
  constexpr int GT = QW * 32;      // threads of a key group
  constexpr int THREADS = GT * KG;
  constexpr int BQ = 16 * QW;
  constexpr int NF = kBK16 / 8;  // score fragments of a warp (16 x 8 each)
  constexpr int OF = DP / 8;     // output fragments of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][DP]

  const int tid = threadIdx.x, lane = tid & 31;
  // Warp (grp, qwarp): query rows 16·qwarp .. of the tile, key tiles
  // grp, grp + KG, ... of the row range, in its group's K and V buffers.
  const int grp = tid / GT, gtid = tid % GT, qwarp = (tid >> 5) % QW;
  __nv_bfloat16* ks = qs + BQ * DP + grp * 2 * kBK16 * DP;  // [64][DP]
  __nv_bfloat16* vs = ks + kBK16 * DP;                      // [64][DP]
  const int g = lane >> 2, t = lane & 3;
  // Query tiles launch heaviest first: under `causal` the last tile sees
  // the most keys, and the tile index is the grid's slowest axis.
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const long long h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const __nv_bfloat16* qg = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kg = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vg = v + b * sv.b + hk * sv.h;

  const int q_end = min(q0 + BQ, len_q);
  const int kv_end = causal ? min(len_kv, q_end) : len_kv;
  const int n_kt = (kv_end + kBK16 - 1) / kBK16;
  const int qw = q0 + 16 * qwarp;  // this warp's first query row
  const int row_lo = qw + g, row_hi = row_lo + 8;
  // ldmatrix row addresses.  Every tile row a lane addresses is lane (mod
  // 8), so one swizzle key serves them all.  Column step kk (16 columns)
  // reads chunk 2·kk + h, h the lane's half (lane / 16 for Q and V, lane / 8
  // % 2 for K), stored at chunk 8·(kk / 4) + ((2·(kk % 4) + h) ^ key): a
  // register per kk % 4 (the *_a arrays, in bytes) plus a constant.
  const int key = swz_key<DP>(lane & 7);
  const int qh = lane >> 4, kh = (lane >> 3) & 1;
  uint32_t q_a[4], k_a[4], v_a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q_a[i] = mma::smem_addr(qs + (16 * qwarp + (lane & 15)) * DP + swz_col(2 * i + qh, key));
    k_a[i] = mma::smem_addr(ks + ((lane & 7) + (qh << 3)) * DP + swz_col(2 * i + kh, key));
    v_a[i] = mma::smem_addr(vs + (lane & 15) * DP + swz_col(2 * i + qh, key));
  }

  load_tile<BQ, DP, THREADS>(qs, qg, sq.s, q0, len_q, dim, vec, tid);
  if (grp < n_kt) load_tile<kBK16, DP, GT>(ks, kg, sk.s, grp * kBK16, len_kv, dim, vec, gtid);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();  // Q, loaded by every thread, is read by every warp

  float acc[OF][4];
#pragma unroll
  for (int f = 0; f < OF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // running max of rows g, g + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};          // this thread's part of the row sums

  for (int j = grp; j < n_kt; j += KG) {
    const int k0 = j * kBK16;
    mma::cp_async_wait<0>();
    group_sync<GT>(grp);  // K_j landed; the group's warps are done with its last V
    load_tile<kBK16, DP, GT>(vs, vg, sv.s, k0, len_kv, dim, vec, gtid);
    mma::cp_async_commit();

    // A warp whose rows all precede the tile's first key sees none of it.
    const bool active = !causal || k0 <= qw + 15;
    float s[NF][4];
    if (active) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[f][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // All of a step's fragments are loaded before its products, so the
        // loads' latencies overlap.
        uint32_t a[4], bb[NF / 2][4];
        mma::ldmatrix_x4(a, q_a[kk % 4] + 128 * (kk / 4));
#pragma unroll
        for (int np = 0; np < NF / 2; ++np)
          mma::ldmatrix_x4(bb[np], k_a[kk % 4] + 2 * 16 * np * DP + 128 * (kk / 4));
#pragma unroll
        for (int np = 0; np < NF / 2; ++np) {
          mma::mma_bf16_16816(s[2 * np], a, bb[np][0], bb[np][1]);
          mma::mma_bf16_16816(s[2 * np + 1], a, bb[np][2], bb[np][3]);
        }
      }

      // Online softmax on the registers (log2 units: exp(x) = 2^(x·log2 e)).
      const bool edge = k0 + kBK16 > len_kv || (causal && k0 + kBK16 - 1 > qw);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[f][e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * f + 2 * t + (e & 1);
            if (key >= len_kv || (causal && key > (e < 2 ? row_lo : row_hi))) x = kNegInf;
          }
          s[f][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
      bool live[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        corr[r] = exp2f(m_r[r] - m_new);
        live[r] = m_new > 0.5f * kNegInf;  // a visible key was seen
        m_r[r] = m_new;
        l_r[r] *= corr[r];
      }
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = live[r] ? exp2f(s[f][e] - m_r[r]) : 0.f;
          l_r[r] += p;
          s[f][e] = p;
        }
#pragma unroll
      for (int f = 0; f < OF; ++f) {
        acc[f][0] *= corr[0];
        acc[f][1] *= corr[0];
        acc[f][2] *= corr[1];
        acc[f][3] *= corr[1];
      }
    }

    mma::cp_async_wait<0>();
    group_sync<GT>(grp);  // V_j landed; the group's warps are done with K_j
    if (j + KG < n_kt)
      load_tile<kBK16, DP, GT>(ks, kg, sk.s, k0 + KG * kBK16, len_kv, dim, vec, gtid);
    mma::cp_async_commit();

    if (active) {
      // p rounded to bf16: score fragments 2kc and 2kc+1 form the A operand
      // of key step kc.
      uint32_t pa[kBK16 / 16][4];
#pragma unroll
      for (int kc = 0; kc < kBK16 / 16; ++kc) {
        pa[kc][0] = mma::pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        pa[kc][1] = mma::pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        pa[kc][2] = mma::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[kc][3] = mma::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      }
      constexpr int G = DP / 16 < 4 ? DP / 16 : 4;  // V fragments loaded together
#pragma unroll
      for (int kc = 0; kc < kBK16 / 16; ++kc)
#pragma unroll
        for (int d0 = 0; d0 < DP / 16; d0 += G) {
          uint32_t bb[G][4];
#pragma unroll
          for (int i = 0; i < G; ++i)
            mma::ldmatrix_x4_trans(bb[i], v_a[(d0 + i) % 4] + 2 * 16 * kc * DP +
                                              128 * ((d0 + i) / 4));
#pragma unroll
          for (int i = 0; i < G; ++i) {
            mma::mma_bf16_16816(acc[2 * (d0 + i)], pa[kc], bb[i][0], bb[i][1]);
            mma::mma_bf16_16816(acc[2 * (d0 + i) + 1], pa[kc], bb[i][2], bb[i][3]);
          }
        }
    }
  }
  mma::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }

  {
    // Merge group 1's (m, l, acc) of each row into group 0's, through the
    // K/V buffers: [QW][OF·4 + 4][32] floats, a lane's values strided by 32
    // (conflict-free).
    constexpr int PER = (OF * 4 + 4) * 32;
    float* xs = reinterpret_cast<float*>(qs + BQ * DP) + qwarp * PER + lane;
    __syncthreads();  // every group is done with its K and V buffers
    if (grp == 1) {
#pragma unroll
      for (int f = 0; f < OF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[(f * 4 + e) * 32] = acc[f][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xs[(OF * 4 + r) * 32] = m_r[r];
        xs[(OF * 4 + 2 + r) * 32] = l_r[r];
      }
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_o = xs[(OF * 4 + r) * 32];
      const float m_new = fmaxf(m_r[r], m_o);
      const float c_self = exp2f(m_r[r] - m_new), c_o = exp2f(m_o - m_new);
      m_r[r] = m_new;
      l_r[r] = l_r[r] * c_self + xs[(OF * 4 + 2 + r) * 32] * c_o;
#pragma unroll
      for (int f = 0; f < OF; ++f) {
        acc[f][2 * r] = acc[f][2 * r] * c_self + xs[(f * 4 + 2 * r) * 32] * c_o;
        acc[f][2 * r + 1] = acc[f][2 * r + 1] * c_self + xs[(f * 4 + 2 * r + 1) * 32] * c_o;
      }
    }
  }

  __nv_bfloat16* og = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(l_r[r], 1e-30f);
    const int row = r ? row_hi : row_lo;
    if (row >= len_q) continue;
    __nv_bfloat16* orow = og + row * so.s;
#pragma unroll
    for (int f = 0; f < OF; ++f) {
      const int d = 8 * f + 2 * t;
      const float x0 = acc[f][2 * r] / den, x1 = acc[f][2 * r + 1] / den;
      if (ovec && d + 1 < dim) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < dim) orow[d] = __float2bfloat16_rn(x0);
        if (d + 1 < dim) orow[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides sq, sk, sv, so;
  int batch, heads, group, len_q, len_kv, dim;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int BQ, int BK, int CN>
int launch_f32(const Args& a) {
  const int smem = static_cast<int>(smem_floats(BQ, BK, CN) * sizeof(float));
  auto kernel = flash_fwd_kernel<BQ, BK, CN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.len_q + BQ - 1) / BQ, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.sq, a.sk, a.sv,
      a.so, a.group, a.len_q, a.len_kv, a.dim, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, int BK>
int launch_f32_cn(int cn, const Args& a) {
  switch (cn) {
    case 1: return launch_f32<BQ, BK, 1>(a);
    case 2: return launch_f32<BQ, BK, 2>(a);
    case 4: return launch_f32<BQ, BK, 4>(a);
    case 8: return launch_f32<BQ, BK, 8>(a);
    case 16: return launch_f32<BQ, BK, 16>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DP>
int launch_bf16(const Args& a, int vec, int ovec) {
  constexpr int BQ = 16 * kQW;
  const int smem = (BQ + 2 * kKG * kBK16) * DP * static_cast<int>(sizeof(__nv_bfloat16));
  auto kernel = flash_bf16_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // shared memory before L1, so that blocks share an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.heads, a.batch, (a.len_q + BQ - 1) / BQ);
  kernel<<<grid, kQW * kKG * 32, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.sq,
      a.sk, a.sv, a.so, a.group, a.len_q, a.len_kv, a.dim, a.scale * kLog2e, a.causal,
      vec, ovec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

}  // namespace

// q [batch, heads, len_q, dim], k/v [batch, heads / group, len_kv, dim] and
// o [batch, heads, len_q, dim], each given by its (batch, head, sequence)
// element strides with a contiguous last dim, all on the current device;
// float32, or bfloat16 when `bf16` is set.  Tiles: float32 takes square
// block_q = block_k in {32, 64, 128}; bfloat16 takes block_q = block_k =
// 64.  Launched on `stream`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int batch, int heads, int kv_heads, int len_q, int len_kv, int dim,
    float scale, int causal, int bf16, int block_q, int block_k, void* stream) {
  if (batch <= 0 || heads <= 0 || len_q <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads || len_kv <= 0 || dim <= 0 ||
      dim > 256 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
               {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
               batch, heads, heads / kv_heads, len_q, len_kv, dim, scale,
               causal, static_cast<cudaStream_t>(stream)};
  if (bf16) {
    if (block_q != 16 * kQW || block_k != kBK16 || (len_q + block_q - 1) / block_q > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    int dp = 16;
    while (dp < dim) dp *= 2;
    bool vec = dim % 8 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16);
    for (long long s : {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss})
      vec = vec && s % 8 == 0;
    const bool ovec = dim % 2 == 0 && aligned(o, 4) && o_sb % 2 == 0 &&
                      o_sh % 2 == 0 && o_ss % 2 == 0;
    switch (dp) {
      case 16: return launch_bf16<16>(a, vec, ovec);
      case 32: return launch_bf16<32>(a, vec, ovec);
      case 64: return launch_bf16<64>(a, vec, ovec);
      case 128: return launch_bf16<128>(a, vec, ovec);
      case 256: return launch_bf16<256>(a, vec, ovec);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cn = 1;
  while (kTX * cn < dim) cn *= 2;
  if (block_q != block_k) return static_cast<int>(cudaErrorInvalidValue);
  switch (block_q) {
    case 32: return launch_f32_cn<32, 32>(cn, a);
    case 64: return launch_f32_cn<64, 64>(cn, a);
    case 128: return launch_f32_cn<128, 128>(cn, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
