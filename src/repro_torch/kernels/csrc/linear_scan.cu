// Diagonal linear recurrence for Hopper (sm_90a): the RG-LRU scan.
//
// Replaces the Pallas TPU kernel `linear_scan` in
// src/repro/kernels/linear_scan/kernel.py (body `_scan_kernel`):
//
//     h_t = a_t * h_{t-1} + b_t      over [B, S, D], from h_{-1} = h0 [B, D]
//
// returning (h_seq [B, S, D] in a's dtype, h_last [B, D] in h0's dtype).
// a and b are float32 or bfloat16 and are loaded to float32; the carry is
// float32 in a register.  h0 may be null (zeros).
//
// Bound.  Pure data movement: a and b read once, h_seq written once, h0 read
// and h_last written once: (3·B·S·D + 2·B·D)·itemsize bytes over 3.35 TB/s.
// At the serving path's float32 prefill groups (D = 2,560) that is 0.0024 ms
// at [1, 256] and [2, 128], 0.0047 ms at [1, 512] and [4, 128], 0.0094 ms at
// [2, 512] and [4, 256]; at the decode shape [8, 1] it is 0.00012 ms, far
// below the cost of a launch (about 0.002 ms on the H100).  Below B = 2 the
// dependency chain binds before the bytes do: one warp walks S steps of a
// rounded multiply and a rounded add, 4.4 ns a step on the H100 alone and
// 7.1 ns with a store a step (tools/kernel_turns.py), so 512 steps take at
// least 3.6 µs on top of the launch, against a 4.7 µs bytes bound at [1, 512].
//
// Design.  One thread owns one (b, d) channel and walks S in order, so the
// rounding is the plain version's.  A block is one warp (32 consecutive
// channels of one batch row) or two; the launcher takes two only where
// that still leaves a block for every SM (kernels/linear_scan/kernel.py,
// `scan_threads`), so B = 2 gives 160 blocks, not the 40 of 128-thread
// blocks.  The block stages a and b through a ring of kRing shared-memory
// stages of kStageElems elements each (64 steps of 32 channels, or 32 of
// 64; 64 KB a block in float32): kRing - 1 stages, 48 KB, are in flight
// while the threads run the chain on the oldest.  Stages are filled with
// 16-byte `cp.async` where a row of the tile is whole 16-byte chunks
// (D·itemsize a multiple of 16, 16-byte aligned bases), else 4-byte
// `cp.async`, else (a bfloat16 row of odd width) element loads; a thread's
// chunks advance by a constant stride, and chunks past D or past S are not
// copied and never read.  The thread for channel d reads its column of a
// stage into registers (consecutive addresses across the warp, no bank
// conflict) before a barrier, so that the chain waits on no shared-memory
// load, then stores h to h_seq a step at a time, 128 coalesced bytes a warp
// in float32.  The ring holds only the stages S needs, and asks for more
// than 48 KB of shared memory only when it holds all four.
//
// S = 1 (a decode step) takes a kernel without a ring: one thread per four
// channels, loaded and stored as vectors where B·D and the bases allow.
//
// Rounding.  h = __fadd_rn(__fmul_rn(a, h), b): a rounded product, then a
// rounded sum, never a fused multiply-add, so the kernel equals the plain
// PyTorch version (`a[:, t] * h + b[:, t]`, two rounded ops) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kRing = 4;           // shared-memory stages
constexpr int kStageElems = 2048;  // elements of a (and of b) in one stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A stage's chunks: CB bytes (kElems elements) each, kRowChunks to a row of
// the tile's TD channels.  Thread i copies the chunks of column
// (i % kRowChunks)·kElems in rows i / kRowChunks + j·kPass, j < kPasses, so
// that its source and destination advance by a constant per chunk.
template <typename TAB, int TD, int CB>
struct Chunks {
  static constexpr int T = kStageElems / TD;
  static constexpr int kElems = CB / static_cast<int>(sizeof(TAB));
  static constexpr int kRowChunks = TD / kElems;
  static constexpr int kPass = TD / kRowChunks;  // rows one pass of the block covers
  static constexpr int kPasses = T / kPass;
  static __device__ __forceinline__ int row() { return threadIdx.x / kRowChunks; }
  static __device__ __forceinline__ int col() { return threadIdx.x % kRowChunks * kElems; }
};

// Rows [0, rows) of a stage of a and b into sa and sb ([T][TD] each), from
// global element offset `off` (this thread's chunk in the stage's first
// pass); `col_ok`: the thread's chunk column lies inside D.  16- or 4-byte
// `cp.async`, or (CB = 2) element loads.
template <typename TAB, int TD, int CB>
__device__ __forceinline__ void load_stage(TAB* sa, TAB* sb, const TAB* a, const TAB* b,
                                           long long off, int rows, long long dim,
                                           bool col_ok) {
  using C = Chunks<TAB, TD, CB>;
  const int r0 = C::row(), k = C::col();
#pragma unroll
  for (int j = 0; j < C::kPasses; ++j) {
    const int r = r0 + j * C::kPass;
    if (!col_ok || r >= rows) continue;
    const long long g = off + static_cast<long long>(j) * C::kPass * dim;
    TAB* da = sa + r * TD + k;
    TAB* db = sb + r * TD + k;
    if constexpr (CB == 16) {
      mma::cp_async_16(mma::smem_addr(da), a + g, 16);
      mma::cp_async_16(mma::smem_addr(db), b + g, 16);
    } else if constexpr (CB == 4) {
      mma::cp_async_4(mma::smem_addr(da), a + g, 4);
      mma::cp_async_4(mma::smem_addr(db), b + g, 4);
    } else {
      *da = a[g];
      *db = b[g];
    }
  }
}

template <typename TAB, typename TH, int TD, int CB>
__global__ void __launch_bounds__(TD) linear_scan_kernel(
    const TAB* __restrict__ a, const TAB* __restrict__ b, const TH* __restrict__ h0,
    TAB* __restrict__ h_seq, TH* __restrict__ h_last, int seq, int dim, int tiles) {
  using C = Chunks<TAB, TD, CB>;
  constexpr int T = C::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int stages = (seq + T - 1) / T;
  const int ring = stages < kRing ? stages : kRing;
  TAB* sa = reinterpret_cast<TAB*>(smem);
  TAB* sb = sa + ring * kStageElems;

  const int row = blockIdx.x / tiles;
  const int d0 = (blockIdx.x - row * tiles) * TD;
  const int d = d0 + threadIdx.x;
  const bool live = d < dim;
  const long long ch = static_cast<long long>(row) * dim + d;
  // This thread's chunks: the element offset of its first one in stage 0,
  // and how far a stage moves it.
  const bool col_ok = d0 + C::col() < dim;
  const long long chunk0 =
      (static_cast<long long>(row) * seq + C::row()) * dim + d0 + C::col();
  const long long stage_step = static_cast<long long>(T) * dim;
  float h = (live && h0) ? to_f32(h0[ch]) : 0.0f;

  for (int s = 0; s < kRing - 1; ++s) {
    if (s < stages)
      load_stage<TAB, TD, CB>(sa + s * kStageElems, sb + s * kStageElems, a, b,
                              chunk0 + s * stage_step, seq - s * T, dim, col_ok);
    mma::cp_async_commit();
  }
  for (int i = 0; i < stages; ++i) {
    mma::cp_async_wait<kRing - 2>();  // stage i has landed
    __syncthreads();                  // ... for every thread, and stage i - 1 is read
    const int next = i + kRing - 1;   // into the buffer of stage i - 1
    if (next < stages)
      load_stage<TAB, TD, CB>(sa + next % kRing * kStageElems, sb + next % kRing * kStageElems,
                              a, b, chunk0 + next * stage_step, seq - next * T, dim, col_ok);
    mma::cp_async_commit();
    const TAB* pa = sa + i % kRing * kStageElems + threadIdx.x;
    const TAB* pb = sb + i % kRing * kStageElems + threadIdx.x;
    TAB* py = h_seq + (static_cast<long long>(row) * seq + i * T) * dim + d;
    const int rows = seq - i * T < T ? seq - i * T : T;
    if (rows == T) {
      // The stage's column into registers, all of it before the barrier, so
      // that the chain below waits on no shared-memory load.
      float av[T], bv[T];
#pragma unroll
      for (int r = 0; r < T; ++r) {
        av[r] = to_f32(pa[r * TD]);
        bv[r] = to_f32(pb[r * TD]);
      }
      __syncthreads();
      if (live) {
#pragma unroll
        for (int r = 0; r < T; ++r) {
          h = __fadd_rn(__fmul_rn(av[r], h), bv[r]);
          store_f32(py + static_cast<long long>(r) * dim, h);
        }
      }
    } else if (live) {  // the last stage
      for (int r = 0; r < rows; ++r) {
        h = __fadd_rn(__fmul_rn(to_f32(pa[r * TD]), h), to_f32(pb[r * TD]));
        store_f32(py + static_cast<long long>(r) * dim, h);
      }
    }
  }
  if (live) store_f32(h_last + ch, h);
}

// S = 1 (a decode step): no ring.  One thread per V consecutive channels,
// loaded and stored as one vector each where the channels and the bases
// allow it (V = 4: 16 bytes of float32, 8 of bfloat16).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename TAB, typename TH, int V>
__global__ void __launch_bounds__(256) linear_scan_step(
    const TAB* __restrict__ a, const TAB* __restrict__ b, const TH* __restrict__ h0,
    TAB* __restrict__ h_seq, TH* __restrict__ h_last, long long channels) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (i >= channels) return;
  const Vec<TAB, V> av = *reinterpret_cast<const Vec<TAB, V>*>(a + i);
  const Vec<TAB, V> bv = *reinterpret_cast<const Vec<TAB, V>*>(b + i);
  Vec<TH, V> hv;
  if (h0) hv = *reinterpret_cast<const Vec<TH, V>*>(h0 + i);
  Vec<TAB, V> y;
  Vec<TH, V> last;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float h = __fadd_rn(__fmul_rn(to_f32(av.v[v]), h0 ? to_f32(hv.v[v]) : 0.0f),
                              to_f32(bv.v[v]));
    store_f32(&y.v[v], h);
    store_f32(&last.v[v], h);
  }
  *reinterpret_cast<Vec<TAB, V>*>(h_seq + i) = y;
  *reinterpret_cast<Vec<TH, V>*>(h_last + i) = last;
}

struct Args {
  const void *a, *b, *h0;
  void *h_seq, *h_last;
  int batch, seq, dim;
  cudaStream_t stream;
};

template <typename TAB, typename TH, int TD, int CB>
int launch(const Args& x) {
  constexpr int T = kStageElems / TD;
  const int stages = (x.seq + T - 1) / T;
  const int ring = stages < kRing ? stages : kRing;
  const int smem = ring * 2 * kStageElems * static_cast<int>(sizeof(TAB));
  auto kernel = linear_scan_kernel<TAB, TH, TD, CB>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)  // shared memory before L1, so that blocks share an SM
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (x.dim + TD - 1) / TD;
  const long long blocks = static_cast<long long>(x.batch) * tiles;
  kernel<<<static_cast<unsigned>(blocks), TD, smem, x.stream>>>(
      static_cast<const TAB*>(x.a), static_cast<const TAB*>(x.b),
      static_cast<const TH*>(x.h0), static_cast<TAB*>(x.h_seq),
      static_cast<TH*>(x.h_last), x.seq, x.dim, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename TAB, typename TH, int TD>
int launch_chunks(const Args& x) {
  const auto aligned = [&](unsigned bytes) {
    return (reinterpret_cast<std::uintptr_t>(x.a) | reinterpret_cast<std::uintptr_t>(x.b)) %
               bytes == 0;
  };
  const long long row_bytes = static_cast<long long>(x.dim) * sizeof(TAB);
  if (row_bytes % 16 == 0 && aligned(16)) return launch<TAB, TH, TD, 16>(x);
  if (row_bytes % 4 == 0 && aligned(4)) return launch<TAB, TH, TD, 4>(x);
  if constexpr (sizeof(TAB) == 2) return launch<TAB, TH, TD, 2>(x);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TAB, typename TH, int V>
int launch_step(const Args& x) {
  const long long channels = static_cast<long long>(x.batch) * x.dim;
  const long long threads = (channels + V - 1) / V;
  linear_scan_step<TAB, TH, V><<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                                 x.stream>>>(
      static_cast<const TAB*>(x.a), static_cast<const TAB*>(x.b),
      static_cast<const TH*>(x.h0), static_cast<TAB*>(x.h_seq),
      static_cast<TH*>(x.h_last), channels);
  return static_cast<int>(cudaGetLastError());
}

template <typename TAB, typename TH>
int launch_width(int threads, const Args& x) {
  if (x.seq == 1) {
    const auto aligned = [](const void* p, unsigned bytes) {
      return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
    };
    const bool vec = static_cast<long long>(x.batch) * x.dim % 4 == 0 &&
                     aligned(x.a, 4 * sizeof(TAB)) && aligned(x.b, 4 * sizeof(TAB)) &&
                     aligned(x.h_seq, 4 * sizeof(TAB)) &&
                     aligned(x.h0, 4 * sizeof(TH)) && aligned(x.h_last, 4 * sizeof(TH));
    return vec ? launch_step<TAB, TH, 4>(x) : launch_step<TAB, TH, 1>(x);
  }
  if (threads == 32) return launch_chunks<TAB, TH, 32>(x);
  return launch_chunks<TAB, TH, 64>(x);
}

}  // namespace

// a, b, h_seq: [batch, seq, dim] contiguous, float32 (ab_bf16 = 0) or
// bfloat16 (ab_bf16 = 1); h0 (may be null) and h_last: [batch, dim]
// contiguous, float32 (h_bf16 = 0) or bfloat16 (h_bf16 = 1).  `threads`
// is the staged kernel's channel tile, 32 or 64 (seq = 1 takes the step
// kernel, whose blocks are fixed).  All on the current device, launched on
// `stream`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int linear_scan(const void* a, const void* b, const void* h0,
                           void* h_seq, void* h_last, int batch, int seq,
                           int dim, int ab_bf16, int h_bf16, int threads,
                           void* stream) {
  if (batch <= 0 || dim <= 0) return 0;
  if (seq < 0 || (threads != 32 && threads != 64) ||
      static_cast<long long>(batch) * ((dim + threads - 1) / threads) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args x{a, b, h0, h_seq, h_last, batch, seq, dim, static_cast<cudaStream_t>(stream)};
  if (!ab_bf16 && !h_bf16) return launch_width<float, float>(threads, x);
  if (!ab_bf16 && h_bf16) return launch_width<float, __nv_bfloat16>(threads, x);
  if (ab_bf16 && !h_bf16) return launch_width<__nv_bfloat16, float>(threads, x);
  return launch_width<__nv_bfloat16, __nv_bfloat16>(threads, x);
}

extern "C" const char* linear_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
