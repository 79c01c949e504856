// Flash attention (forward) for Hopper (sm_90a), on CUDA cores.
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
// only under `causal`.  For bfloat16 the probabilities are rounded to
// bfloat16 before the P·V product, as the JAX kernel does; the running sum l
// adds the unrounded ones.  The output is acc / max(l, 1e-30).
//
// Design.  The TPU kernel walked the key tiles as the innermost, sequential
// grid axis with (m, l, acc) in VMEM scratch; Hopper blocks run in parallel
// and in no order, so here one block of 256 threads owns one (b, h, query
// tile of BQ rows) and loops over the key tiles of BK rows itself.  Query
// head h reads kv head h / G in place: k and v are never repeated G times.
// Every tensor is addressed through (batch, head, sequence) strides with a
// contiguous last dim, so the model layout [B, S, H, D] is read and written
// without a transpose.  Per key tile:
//   1. K's tile is staged in shared memory as float32 (rows past Skv and
//      columns past D are zeros).  The Q tile was staged once.  Both have an
//      odd row pitch, so the 16 threads of a half-warp, reading 16 rows at
//      one column, hit 16 distinct banks.
//   2. S = Q K^T: thread (tx, ty) keeps a (BQ/16) x (BK/16) register tile
//      (rows ty·BQ/16 + i, columns tx + 16·j) and accumulates it with fp32
//      FMAs over D.  Scaled, masked scores go to a key-major P tile.
//   3. Online softmax, one warp per query row, lanes along the keys: the
//      new running max, p = exp(s - m) (p = 0 while the row has seen no
//      visible key), the row sum and the correction exp(m_old - m_new).
//   4. V's tile replaces K's in the same buffer, and each thread rescales
//      and accumulates its (BQ/16) x CN output tile (the same rows, columns
//      tx + 16·j) from P and V.  The accumulator stays in registers for the
//      whole loop.
// With `causal`, key tiles wholly above the diagonal are never visited.
// The ragged ends of Sq, Skv and D are masked on load and on store; nothing
// is padded in device memory.  D <= 256; D is padded to a register tile of
// 16·CN columns (CN = 1, 2, 4, 8 or 16).  Square tiles BQ = BK in
// {32, 64, 128} that fit the 227 KB of shared memory a block may use.
//
// Bound.  Bytes: q, k and v read once, o written once:
// (2·B·H·Sq + 2·B·Hkv·Skv)·D·itemsize.  Operations: 4·D per visible
// (query, key) pair, about 4·B·H·Sq·Skv·D / 2 when causal.  At the serving
// prompt group [2, 512, 10 x 256] in bfloat16 that is 11.5 MB and 2.68 GFLOP:
// 3.4 µs at 3.35 TB/s, 2.7 µs at the 989 TFLOP/s bf16 tensor-core peak, so
// the card's bound is set by bytes.  This first version runs fp32 FMAs on
// CUDA cores (67 TFLOP/s peak, 40 µs for that work) with shared-memory
// operands, so it is far from either bound; mma/wgmma tiles fed by TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;  // threads along keys (scores) and head dim (output)
constexpr int kTY = 16;  // threads along queries
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // in elements; the head dim is contiguous
};

constexpr long long smem_floats(int bq, int bk, int cn) {
  return static_cast<long long>(bq) * (kTX * cn + 1) +  // Q tile
         static_cast<long long>(bk) * (kTX * cn + 1) +  // K, then V, tile
         static_cast<long long>(bk) * (bq + 1) +        // P tile, key-major
         3LL * bq;                                      // m, l, correction
}

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
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
flash_fwd_kernel(const void* __restrict__ q, const void* __restrict__ k,
                 const void* __restrict__ v, void* __restrict__ o,
                 Strides sq, Strides sk, Strides sv, Strides so, int group,
                 int len_q, int len_kv, int dim, float scale, int causal,
                 int bf16) {
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
    qs[r * LD + d] = (q0 + r < len_q && d < dim)
                         ? load(q, qb + (q0 + r) * sq.s + d, bf16) : 0.f;
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
      kvs[r * LD + d] = (k0 + r < len_kv && d < dim)
                            ? load(k, kb + (k0 + r) * sk.s + d, bf16) : 0.f;
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
        ps[c * LP + r] = bf16 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
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
      kvs[r * LD + d] = (k0 + r < len_kv && d < dim)
                            ? load(v, vb + (k0 + r) * sv.s + d, bf16) : 0.f;
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
      if (d >= dim) continue;
      const float x = acc[i][j] / den;
      if (bf16)
        static_cast<__nv_bfloat16*>(o)[row + d] = __float2bfloat16_rn(x);
      else
        static_cast<float*>(o)[row + d] = x;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides sq, sk, sv, so;
  int batch, heads, group, len_q, len_kv, dim;
  float scale;
  int causal, bf16;
  cudaStream_t stream;
};

template <int BQ, int BK, int CN>
int launch(const Args& a) {
  const int smem = static_cast<int>(smem_floats(BQ, BK, CN) * sizeof(float));
  auto kernel = flash_fwd_kernel<BQ, BK, CN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.len_q + BQ - 1) / BQ, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.o, a.sq, a.sk, a.sv, a.so, a.group, a.len_q, a.len_kv,
      a.dim, a.scale, a.causal, a.bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, int BK>
int launch_cn(int cn, const Args& a) {
  switch (cn) {
    case 1: return launch<BQ, BK, 1>(a);
    case 2: return launch<BQ, BK, 2>(a);
    case 4: return launch<BQ, BK, 4>(a);
    case 8: return launch<BQ, BK, 8>(a);
    case 16: return launch<BQ, BK, 16>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [batch, heads, len_q, dim], k/v [batch, heads / group, len_kv, dim] and
// o [batch, heads, len_q, dim], each given by its (batch, head, sequence)
// element strides with a contiguous last dim, all on the current device;
// float32, or bfloat16 when `bf16` is set.  Launched on `stream`.
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
  int cn = 1;
  while (kTX * cn < dim) cn *= 2;
  const Args a{q, k, v, o,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
               {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
               batch, heads, heads / kv_heads, len_q, len_kv, dim, scale,
               causal, bf16, static_cast<cudaStream_t>(stream)};
  if (block_q != block_k) return static_cast<int>(cudaErrorInvalidValue);
  switch (block_q) {
    case 32: return launch_cn<32, 32>(cn, a);
    case 64: return launch_cn<64, 64>(cn, a);
    case 128: return launch_cn<128, 128>(cn, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
