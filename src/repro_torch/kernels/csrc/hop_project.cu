// One diffusion hop fused with its projection, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `hop_project` in
// src/repro/kernels/diffusion_conv/kernel.py (body `_hop_project_kernel`):
//
//     Z_next[m, b, :] = sum_n S[m, n] · Z[n, b, :]        S [N, N], Z [N, B, C]
//     Y_next[m, b, :] = Y[m, b, :] + Z_next[m, b, :] @ W  W [C, H], Y [N, B, H]
//
// All fp32, fp32 accumulation, no TF32.
//
// Design.  The TPU kernel carried the reduction over node blocks j across
// sequential grid steps; Hopper runs blocks in parallel and in no order, so
// here the whole reduction over n is a loop inside one block.  The grid is
// (node-row block, batch index b).  Each block of 256 threads (16 × 16)
// computes the [64, C] tile Z_next[rows, b, :]:
//   - per step of 32 nodes it stages the S tile [64, 32] and the Z tile
//     [32, C] = Z[k0:k0+32, b, :] in shared memory.  S is stored n-major
//     (row stride 68 floats, so each thread reads its 4 rows as one float4);
//     a warp loads 4 rows × 8 nodes of S, 32-byte runs along n in device
//     memory, which land on 32 distinct banks when stored;
//   - each thread keeps a 4 × CPT register tile (rows 4·ty.., columns
//     tx + 16·j) and accumulates it with fp32 FMAs;
//   - the finished tile is written to Z_next and staged in shared memory,
//     and the fused epilogue adds Z_tile @ W to Y rows [rows, b, :] (W read
//     through the read-only cache).
// The ragged N edge and the columns past C are masked with zeros on load
// and skipped on store; nothing is padded in device memory.  C <= 128.
// The launch runs on the caller's current device and the given stream.
//
// Bound.  Operations: 2·N²·B·C for the hop plus 2·N·B·C·H for the
// projection.  Bytes: S read once, Z and Y read once, Z_next and Y_next
// written once: 4·(N² + 2·N·B·C + 2·N·B·H + C·H).  At the main-path shape
// (N = 2716, B = 32, C = 66, H = 128) that is 32.6 GFLOP against 164 MB:
// about 200 FLOP per byte, far above the fp32 ridge of the H100 (67 TFLOP/s
// over 3.35 TB/s, 20 FLOP per byte), so the kernel is bound by fp32
// operations.  This first version uses CUDA-core FMAs only; the tensor-core
// (wgmma/TMA) version is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kBlockK = 32;                // nodes per reduction step
constexpr int kRowsPerThread = 4;          // one float4 of the S tile
constexpr int kBlockM = kThreadsY * kRowsPerThread;  // node rows per block
constexpr int kSPitch = kBlockM + 4;       // row of the n-major S tile

template <int CPT>
__global__ void __launch_bounds__(kThreads)
hop_project_kernel(const float* __restrict__ s, const float* __restrict__ z,
                   const float* __restrict__ w, const float* __restrict__ y,
                   float* __restrict__ z_out, float* __restrict__ y_out,
                   int n, int bsz, int c, int h) {
  constexpr int CP = kThreadsX * CPT;  // feature columns, padded
  extern __shared__ __align__(16) float smem[];
  float* s_tile = smem;                     // [kBlockK][kSPitch]
  float* z_tile = smem + kBlockK * kSPitch; // [kBlockK][CP]; [kBlockM][CP] in the epilogue

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y;
  const long long zrow = static_cast<long long>(bsz) * c;  // stride of a node in Z
  const long long zcol = static_cast<long long>(b) * c;    // offset of batch b

  float acc[kRowsPerThread][CPT];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    // S tile: pass p of warp w loads rows 4·(w + 8·(p / 4)) + lane / 8 at
    // nodes 8·(p % 4) + lane % 8.  The store's bank is
    // (4·kk + r) mod 32 = 4·(lane % 8) + lane / 8 + const: all 32 differ.
#pragma unroll
    for (int p = 0; p < kBlockM * kBlockK / kThreads; ++p) {
      const int r = 4 * (warp + 8 * (p / 4)) + lane / 8;
      const int kk = 8 * (p % 4) + lane % 8;
      const int gr = row0 + r, gk = k0 + kk;
      s_tile[kk * kSPitch + r] =
          (gr < n && gk < n) ? s[static_cast<long long>(gr) * n + gk] : 0.f;
    }
    for (int e = tid; e < kBlockK * CP; e += kThreads) {
      const int kk = e / CP, cc = e % CP;
      const int gk = k0 + kk;
      z_tile[e] = (gk < n && cc < c) ? z[gk * zrow + zcol + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(
          s_tile + kk * kSPitch + ty * kRowsPerThread);
      const float av[kRowsPerThread] = {a.x, a.y, a.z, a.w};
      float v[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) v[j] = z_tile[kk * CP + tx + j * kThreadsX];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Z_next out, and the tile staged for the projection.
  float* t_tile = z_tile;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty * kRowsPerThread + i;
    const int gr = row0 + r;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int cc = tx + j * kThreadsX;
      t_tile[r * CP + cc] = acc[i][j];
      if (gr < n && cc < c) z_out[gr * zrow + zcol + cc] = acc[i][j];
    }
  }
  __syncthreads();

  // Fused epilogue: Y_next[rows, b, :] = Y[rows, b, :] + Z_tile @ W.
  for (int e = tid; e < kBlockM * h; e += kThreads) {
    const int r = e / h, hh = e % h;
    const int gr = row0 + r;
    if (gr >= n) break;  // r only grows with e
    const float* trow = t_tile + r * CP;
    float sum = 0.f;
    for (int cc = 0; cc < c; ++cc) sum = fmaf(trow[cc], __ldg(w + cc * h + hh), sum);
    const long long o = (static_cast<long long>(gr) * bsz + b) * h + hh;
    y_out[o] = y[o] + sum;
  }
}

template <int CPT>
int launch(const float* s, const float* z, const float* w, const float* y,
           float* z_out, float* y_out, int n, int bsz, int c, int h,
           cudaStream_t stream) {
  constexpr int CP = kThreadsX * CPT;
  constexpr int rows = kBlockM > kBlockK ? kBlockM : kBlockK;
  const size_t smem = sizeof(float) * (kBlockK * kSPitch + rows * CP);
  const dim3 grid((n + kBlockM - 1) / kBlockM, bsz);
  hop_project_kernel<CPT><<<grid, kThreads, smem, stream>>>(
      s, z, w, y, z_out, y_out, n, bsz, c, h);
  return static_cast<int>(cudaGetLastError());
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
  if (c <= 0 || c > 8 * kThreadsX || h < 0 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((c + kThreadsX - 1) / kThreadsX) {
    case 1: return launch<1>(s, z, w, y, z_out, y_out, n, bsz, c, h, st);
    case 2: return launch<2>(s, z, w, y, z_out, y_out, n, bsz, c, h, st);
    case 3: return launch<3>(s, z, w, y, z_out, y_out, n, bsz, c, h, st);
    case 4: return launch<4>(s, z, w, y, z_out, y_out, n, bsz, c, h, st);
    case 5: return launch<5>(s, z, w, y, z_out, y_out, n, bsz, c, h, st);
    case 6: return launch<6>(s, z, w, y, z_out, y_out, n, bsz, c, h, st);
    case 7: return launch<7>(s, z, w, y, z_out, y_out, n, bsz, c, h, st);
    default: return launch<8>(s, z, w, y, z_out, y_out, n, bsz, c, h, st);
  }
}

extern "C" const char* hop_project_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
