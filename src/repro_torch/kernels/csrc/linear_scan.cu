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
// Design.  The recurrence is elementwise over (B, D) and sequential over S.
// On the TPU the sequence axis was the innermost, sequential grid axis with
// the carry in VMEM scratch; Hopper blocks run in parallel and in no order,
// so the sequential axis becomes a loop inside one thread.  One thread owns
// one (b, d) channel, d fastest, so a warp's loads of a[b, t, d0:d0+32]
// are coalesced.  The loop loads U steps of a and b ahead into registers,
// then runs the U multiply-adds, so the loads of a chunk are all in flight
// together and only the multiply-add sits on the dependency chain.  S is not
// padded (the JAX wrapper padded it with identity steps): the tail runs a
// plain loop to S exactly.  Any D works, ragged ones included.
//
// Rounding.  h = __fadd_rn(__fmul_rn(a, h), b): a rounded product, then a
// rounded sum, never a fused multiply-add, so the kernel equals the plain
// PyTorch version (`a[:, t] * h + b[:, t]`, two rounded ops) bit for bit.
//
// Bound.  Pure data movement: a and b read once, h_seq written once, h0 read
// and h_last written once: (3·B·S·D + 2·B·D)·itemsize bytes over device-memory
// bandwidth.  At the RG-LRU prefill shape [8, 512, 2560] in float32 that is
// 126 MB, 0.038 ms at 3.35 TB/s.  At the decode shape [8, 1, 2560] it is
// 0.33 MB, far below a launch's own cost: decode is launch-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 8;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TAB, typename TH>
__global__ void linear_scan_kernel(const TAB* __restrict__ a,
                                   const TAB* __restrict__ b,
                                   const TH* __restrict__ h0,
                                   TAB* __restrict__ h_seq,
                                   TH* __restrict__ h_last,
                                   long long channels, int seq, int dim) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= channels) return;
  const long long row = i / dim;
  const long long d = i - row * dim;
  const long long base = row * seq * dim + d;
  const TAB* pa = a + base;
  const TAB* pb = b + base;
  TAB* py = h_seq + base;
  float h = h0 ? load_f32(h0 + i) : 0.0f;

  int t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = static_cast<long long>(t + u) * dim;
      av[u] = load_f32(pa + off);
      bv[u] = load_f32(pb + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      store_f32(py + static_cast<long long>(t + u) * dim, h);
    }
  }
  for (; t < seq; ++t) {
    const long long off = static_cast<long long>(t) * dim;
    h = __fadd_rn(__fmul_rn(load_f32(pa + off), h), load_f32(pb + off));
    store_f32(py + off, h);
  }
  store_f32(h_last + i, h);
}

template <typename TAB, typename TH>
int launch(const void* a, const void* b, const void* h0, void* h_seq,
           void* h_last, long long channels, int seq, int dim, int threads,
           cudaStream_t stream) {
  const long long blocks = (channels + threads - 1) / threads;
  linear_scan_kernel<TAB, TH><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const TAB*>(a), static_cast<const TAB*>(b),
      static_cast<const TH*>(h0), static_cast<TAB*>(h_seq),
      static_cast<TH*>(h_last), channels, seq, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, h_seq: [batch, seq, dim] contiguous, float32 (ab_bf16 = 0) or
// bfloat16 (ab_bf16 = 1); h0 (may be null) and h_last: [batch, dim]
// contiguous, float32 (h_bf16 = 0) or bfloat16 (h_bf16 = 1).  All on the
// current device, launched on `stream`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int linear_scan(const void* a, const void* b, const void* h0,
                           void* h_seq, void* h_last, int batch, int seq,
                           int dim, int ab_bf16, int h_bf16, int threads,
                           void* stream) {
  const long long channels = static_cast<long long>(batch) * dim;
  if (channels <= 0) return 0;
  if (seq < 0 || threads <= 0 || threads > 1024 ||
      (channels + threads - 1) / threads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!ab_bf16 && !h_bf16)
    return launch<float, float>(a, b, h0, h_seq, h_last, channels, seq, dim, threads, st);
  if (!ab_bf16 && h_bf16)
    return launch<float, __nv_bfloat16>(a, b, h0, h_seq, h_last, channels, seq, dim, threads, st);
  if (ab_bf16 && !h_bf16)
    return launch<__nv_bfloat16, float>(a, b, h0, h_seq, h_last, channels, seq, dim, threads, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(a, b, h0, h_seq, h_last, channels, seq, dim, threads, st);
}

extern "C" const char* linear_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
