// One diffusion hop fused with its projection, for Hopper (sm_90a), on the
// tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel `hop_project` in
// src/repro/kernels/diffusion_conv/kernel.py (body `_hop_project_kernel`):
//
//     Z_next[m, b, :] = sum_n S[m, n] · Z[n, b, :]        S [N, N], Z [N, B, C]
//     Y_next[m, b, :] = Y[m, b, :] + Z_next[m, b, :] @ W  W [C, H], Y [N, B, H]
//
// fp32 in and out, fp32 accumulation.  The TPU kernel carried the reduction
// over node blocks across sequential grid steps; Hopper runs blocks in
// parallel and in no order, so here the whole reduction over n is a loop
// inside one block.
//
// Bound.  Operations: 2·N²·B·C for the hop plus 2·N·B·C·H for the
// projection.  Bytes: S read once, Z and Y read once, Z_next and Y_next
// written once: 4·(N² + 2·N·B·C + 2·N·B·H + C·H).  At the main-path shape
// (N = 2716, B = 32, C = 66, H = 128) that is 32.6 GFLOP against 164 MB, far
// above the ridge of every fp32 route.  One TF32 product loses the fp32
// tolerance (TF32 keeps 10 mantissa bits), so the fastest route on this
// card that keeps fp32 accuracy is 3xTF32: a·b ≈ a_hi·b_hi + a_hi·b_lo +
// a_lo·b_hi with a_hi = tf32(a) and a_lo = tf32(a - a_hi), accumulated in
// fp32 (the lo·lo term is below fp32's rounding).  Three TF32 products at
// 495 TFLOP/s take 0.196 ms there; the bytes take 0.049 ms.  So the kernel
// is bound by tensor-core operations.
//
// Design.  The hop is the GEMM [N, N] · [N, B·C] with a per-batch-element
// epilogue.
//   - A block owns BN = 64 rows of S and NB whole batch elements of
//     Z, whose rows are NB·C contiguous floats of each node row of Z (264 at
//     C = 66, NB = 4; the tile is 288 columns wide, zero-filled past them).
//     So each S tile staged in shared memory serves NB batch elements, and S
//     is read from L2 B / NB times per hop, not B times.
//   - Per step of 32 nodes, cp.async stages the S tile [BN][32] and the Z
//     tile [32][288], double-buffered, so the next step's loads run under
//     this step's products.  The copies are 16 bytes wide where rows are
//     16-byte aligned (N % 4 == 0 for S; B·C and NB·C multiples of 4 for Z),
//     else 4 bytes.  Rows past N, nodes past N and columns past the block's
//     batch elements are zero-filled by the copies; nothing is padded in
//     device memory.
//   - Four warps side by side each own a 64 x 72 register tile
//     of Z_next (4 x 9 m16n8 fragments, 144 floats a thread).  Fragments
//     are read from shared memory at pitches that make every read
//     conflict-free, split into hi and lo TF32 in registers, and fed to
//     three m16n8k8 TF32 mma.sync each, issued term by term over 12
//     accumulators so that no product waits on the one before it.
//   - Epilogue: the tile goes to shared memory, Z_next is written from
//     there, and Y += Z_tile @ W runs as 3xTF32 mma.sync too, one warp per
//     16 rows: batch element bi's operand is tile columns bi·C ..
//     bi·C + CP - 1 (CP = C rounded up to 8) against W staged in shared
//     memory, its rows zero past C, 64 columns of H at a time.
// C <= 128.  Forward only, as the TPU kernel.  The launch runs on the
// caller's current device and the given stream.
// What still bounds it: mma.sync reaches part of Hopper's TF32 rate (wgmma
// is the full rate); the hi/lo split costs ALU operations for every operand
// element a warp loads; each row block reloads its Z tiles from L2 through
// the same warps that run the products; and at N = 2716 the 43 x 8 blocks
// (two per SM) are 1.3 waves.  A 128-row tile (8 warps, one block per SM)
// measured slower at that shape (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kBN = 64;          // rows of S per block
constexpr int kThreads = 128;    // four warps side by side along the columns
constexpr int kBK = 32;          // nodes per reduction step
constexpr int kStages = 2;       // tiles in the cp.async ring
constexpr int kCols = 288;       // Z columns per block: NB batch elements of CP
constexpr int kWarpN = kCols / 4;  // 72 columns per warp
constexpr int kNF = kWarpN / 8;  // 9 n-fragments per warp
constexpr int kMF = 4;           // 4 m-fragments per warp: 64 rows
constexpr int kSP = kBK + 4;     // S tile pitch, 36 ≡ 4 (mod 32): A reads hit 32 banks
constexpr int kZP = kCols + 8;   // Z tile pitch, 296 ≡ 8 (mod 32): B reads hit 32 banks
constexpr int kTP = kCols + 4;   // Z_next tile pitch, 292 ≡ 4 (mod 32): A reads too
constexpr int kHB = 64;          // H columns per epilogue pass
constexpr int kWP = kHB + 8;     // W tile pitch, 72 ≡ 8 (mod 32)
static_assert(kNF % 3 == 0, "n-fragments are issued three at a time");

// Term `term` of acc += a · b in 3xTF32: a_lo·b_hi, a_hi·b_lo, then
// a_hi·b_hi (the small terms first).  Callers issue one term over many
// accumulators before the next, so that no product waits on the one before.
__device__ __forceinline__ void mma_3xtf32_term(int term, float (&acc)[4],
                                                const uint32_t (&ahi)[4],
                                                const uint32_t (&alo)[4],
                                                const uint32_t (&bhi)[2],
                                                const uint32_t (&blo)[2]) {
  mma::mma_tf32_1688(acc, term == 0 ? alo : ahi, term == 1 ? blo : bhi);
}

// The A fragment of rows (g, g + 8) and columns (t, t + 4) at `p` (the
// element (g, t)) of a row-major fp32 tile of pitch `pitch`, split.
__device__ __forceinline__ void load_a(const float* p, int pitch, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  mma::split_tf32(p[0], hi[0], lo[0]);
  mma::split_tf32(p[8 * pitch], hi[1], lo[1]);
  mma::split_tf32(p[4], hi[2], lo[2]);
  mma::split_tf32(p[8 * pitch + 4], hi[3], lo[3]);
}

// The B fragment of rows (t, t + 4) at `p` (the element (t, g)) of a
// k-major fp32 tile of pitch `pitch`, split.
__device__ __forceinline__ void load_b(const float* p, int pitch, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  mma::split_tf32(p[0], hi[0], lo[0]);
  mma::split_tf32(p[4 * pitch], hi[1], lo[1]);
}

__global__ void __launch_bounds__(kThreads)
hop_project_kernel(const float* __restrict__ s, const float* __restrict__ z,
                   const float* __restrict__ w, const float* __restrict__ y,
                   float* __restrict__ z_out, float* __restrict__ y_out,
                   int n, int bsz, int c, int h, int cp, int nb, int svec, int zvec) {
  constexpr int BN = kBN, THREADS = kThreads, WARPS = THREADS / 32;
  extern __shared__ __align__(16) float smem[];
  // Main loop: a ring of kStages S and Z tiles.  Epilogue, over the same
  // bytes: the Z_next tile and a W chunk.
  float* s_tile = smem;                         // [kStages][BN][kSP]
  float* z_tile = s_tile + kStages * BN * kSP;   // [kStages][kBK][kZP]
  float* t_tile = smem;                    // [BN][kTP]
  float* w_tile = t_tile + BN * kTP;       // [cp][kWP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp;
  const int row0 = blockIdx.x * BN, b0 = blockIdx.y * nb;
  const long long zrow = static_cast<long long>(bsz) * c;  // stride of a node in Z
  // The block's batch elements b0 .. b0 + live_b - 1 are lspan contiguous
  // floats of each row of Z: column j of the Z tile is Z[node, b0, j].
  const int live_b = min(nb, bsz - b0);
  const int lspan = live_b * c;
  const float* zb0 = z + static_cast<long long>(b0) * c;

  auto load = [&](int stage, int k0) {
    float* sd = s_tile + stage * BN * kSP;
    if (svec) {  // n % 4 == 0: whole 16-byte chunks
#pragma unroll
      for (int i = tid; i < BN * (kBK / 4); i += THREADS) {
        const int r = i / (kBK / 4), k4 = 4 * (i % (kBK / 4));
        const int gr = row0 + r, gk = k0 + k4;
        const bool ok = gr < n && gk < n;
        mma::cp_async_16(mma::smem_addr(sd + r * kSP + k4),
                         ok ? s + static_cast<long long>(gr) * n + gk : s, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < BN * kBK; i += THREADS) {
        const int r = i / kBK, kk = i % kBK;
        const int gr = row0 + r, gk = k0 + kk;
        const bool ok = gr < n && gk < n;
        mma::cp_async_4(mma::smem_addr(sd + r * kSP + kk),
                        ok ? s + static_cast<long long>(gr) * n + gk : s, ok ? 4 : 0);
      }
    }
    float* zd = z_tile + stage * kBK * kZP;
    if (zvec) {  // rows and the block's span 16-byte aligned; a ragged end zero-filled
#pragma unroll
      for (int i = tid; i < kBK * (kCols / 4); i += THREADS) {
        const int kk = i / (kCols / 4), j = 4 * (i % (kCols / 4));
        const int gk = k0 + kk;
        const int bytes = gk < n ? 4 * min(max(lspan - j, 0), 4) : 0;
        mma::cp_async_16(mma::smem_addr(zd + kk * kZP + j),
                         bytes ? zb0 + gk * zrow + j : z, bytes);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < kBK * kCols; i += THREADS) {
        const int kk = i / kCols, j = i % kCols;
        const int gk = k0 + kk;
        const bool ok = gk < n && j < lspan;
        mma::cp_async_4(mma::smem_addr(zd + kk * kZP + j), ok ? zb0 + gk * zrow + j : z,
                        ok ? 4 : 0);
      }
    }
  };

  float acc[kMF][kNF][4];
#pragma unroll
  for (int mi = 0; mi < kMF; ++mi)
#pragma unroll
    for (int f = 0; f < kNF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][f][e] = 0.f;

  const int n_steps = (n + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(st, st * kBK);
    mma::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    mma::cp_async_wait<kStages - 2>();  // this step's tiles landed
    // ... and every warp is done with the stage the next load refills (the
    // one step - 1 read).
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < n_steps) load(next % kStages, next * kBK);
    mma::cp_async_commit();
    const int cur = step % kStages;
    const float* sa = s_tile + cur * BN * kSP + g * kSP + t;
    const float* zb = z_tile + cur * kBK * kZP + t * kZP + wn * kWarpN + g;
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      uint32_t ahi[kMF][4], alo[kMF][4];
#pragma unroll
      for (int mi = 0; mi < kMF; ++mi) load_a(sa + mi * 16 * kSP + k8, kSP, ahi[mi], alo[mi]);
      // Three n-fragments at a time, term by term: 12 independent products
      // between two on the same accumulator.
#pragma unroll
      for (int f0 = 0; f0 < kNF; f0 += 3) {
        uint32_t bhi[3][2], blo[3][2];
#pragma unroll
        for (int i = 0; i < 3; ++i) load_b(zb + k8 * kZP + 8 * (f0 + i), kZP, bhi[i], blo[i]);
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            if (wn * kWarpN + 8 * (f0 + i) >= lspan) continue;  // zero columns only
#pragma unroll
            for (int mi = 0; mi < kMF; ++mi)
              mma_3xtf32_term(term, acc[mi][f0 + i], ahi[mi], alo[mi], bhi[i], blo[i]);
          }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before the epilogue reuses it

  // The Z_next tile to shared memory: all kCols columns, zeros past lspan.
#pragma unroll
  for (int mi = 0; mi < kMF; ++mi)
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      const int r = mi * 16 + g, col = wn * kWarpN + 8 * f + 2 * t;
      t_tile[r * kTP + col] = acc[mi][f][0];
      t_tile[r * kTP + col + 1] = acc[mi][f][1];
      t_tile[(r + 8) * kTP + col] = acc[mi][f][2];
      t_tile[(r + 8) * kTP + col + 1] = acc[mi][f][3];
    }
  __syncthreads();

  // Z_next out: each row's lspan floats, contiguous in Z_next too.
  for (int r = warp; r < BN && row0 + r < n; r += WARPS) {
    float* dst = z_out + (row0 + r) * zrow + static_cast<long long>(b0) * c;
    for (int e = lane; e < lspan; e += 32) dst[e] = t_tile[r * kTP + e];
  }

  // Y_next = Y + Z_tile @ W, per batch element, one warp per 16 rows.  The
  // A operand of batch element bi is columns bi·c .. bi·c + cp - 1 of the
  // tile (the next element's columns, or zeros, past c), against W's rows
  // zero-filled past c.
  const int r0 = warp * 16;
  for (int h0 = 0; h0 < h; h0 += kHB) {
    __syncthreads();  // every warp is done with the previous W chunk
    for (int i = tid; i < cp * kHB; i += THREADS) {
      const int kk = i / kHB, hh = i % kHB;
      w_tile[kk * kWP + hh] = (kk < c && h0 + hh < h) ? w[kk * h + h0 + hh] : 0.f;
    }
    __syncthreads();
    if (row0 + r0 >= n) continue;
    for (int bi = 0; bi < live_b; ++bi) {
      float ya[kHB / 8][4];
#pragma unroll
      for (int f = 0; f < kHB / 8; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[f][e] = 0.f;
      for (int k8 = 0; k8 < cp; k8 += 8) {
        uint32_t ahi[4], alo[4], bhi[kHB / 8][2], blo[kHB / 8][2];
        load_a(t_tile + (r0 + g) * kTP + bi * c + k8 + t, kTP, ahi, alo);
#pragma unroll
        for (int f = 0; f < kHB / 8; ++f)
          load_b(w_tile + (k8 + t) * kWP + 8 * f + g, kWP, bhi[f], blo[f]);
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int f = 0; f < kHB / 8; ++f)
            if (h0 + 8 * f < h) mma_3xtf32_term(term, ya[f], ahi, alo, bhi[f], blo[f]);
      }
      const long long yb = b0 + bi;
#pragma unroll
      for (int f = 0; f < kHB / 8; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gr = row0 + r0 + g + ((e >> 1) << 3);
          const int hh = h0 + 8 * f + 2 * t + (e & 1);
          if (gr < n && hh < h) {
            const long long o = (gr * static_cast<long long>(bsz) + yb) * h + hh;
            y_out[o] = y[o] + ya[f][e];
          }
        }
    }
  }
}

}  // namespace

// s: [n, n], z: [n, bsz, c], w: [c, h], y: [n, bsz, h], all contiguous fp32;
// z_out: [n, bsz, c], y_out: [n, bsz, h]; all on the current device,
// launched on `stream`.  c <= 128.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int hop_project_f32(const float* s, const float* z, const float* w,
                               const float* y, float* z_out, float* y_out,
                               int n, int bsz, int c, int h, void* stream) {
  if (n <= 0 || bsz <= 0) return 0;
  if (c <= 0 || c > 128 || h < 0) return static_cast<int>(cudaErrorInvalidValue);
  // NB batch elements per block, so that the epilogue's last operand
  // columns, (NB - 1)·c + cp, stay inside the tile.
  const int cp = (c + 7) / 8 * 8, nb = (kCols - cp) / c + 1;
  if ((bsz + nb - 1) / nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const int svec = n % 4 == 0 && aligned(s);
  const int zvec = (static_cast<long long>(bsz) * c) % 4 == 0 && (nb * c) % 4 == 0 && aligned(z);
  const size_t main_floats = static_cast<size_t>(kStages) * (kBN * kSP + kBK * kZP);
  const size_t epi_floats = static_cast<size_t>(kBN) * kTP + static_cast<size_t>(cp) * kWP;
  const size_t smem = sizeof(float) * (main_floats > epi_floats ? main_floats : epi_floats);
  auto kernel = hop_project_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (bsz + nb - 1) / nb);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      s, z, w, y, z_out, y_out, n, bsz, c, h, cp, nb, svec, zvec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hop_project_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
