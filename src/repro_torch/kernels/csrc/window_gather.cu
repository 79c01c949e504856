// Index-batching window gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `window_gather` in
// src/repro/kernels/window_gather/kernel.py (body `_gather_kernel`):
//
//     out[b, t, :] = series[first(starts[b]) + t, :]     for t < span
//
// with the start rule of `jax.lax.dynamic_slice`, which the reference oracle
// uses: a negative start counts from the end (s + T), and the result is
// clamped to [0, T - span].  No start ever reads out of bounds.
//
// Design.  One block per output row (b, t); the block reads its own
// starts[b] (on the TPU the starts were scalar-prefetched ahead of the grid).
// The row is copied as raw bytes, so any dtype works (f32 and int32 on the
// tested paths).  The vector width is the widest of 16, 8, 4 or 1 bytes that
// divides the row and both base pointers; neighbouring threads move
// neighbouring vectors, so every load and store is coalesced, and the loop
// bound masks the ragged end of the row.  Nothing is padded.
//
// Bound.  Pure data movement: each output byte is read once and written once,
// 2·B·span·C·itemsize bytes over device-memory bandwidth.  At the main-path
// shape (series [8640, 5432] f32, B = 32, span = 24) that is 33.4 MB.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename V>
__global__ void window_gather_kernel(const char* __restrict__ series,
                                     const int* __restrict__ starts,
                                     char* __restrict__ out,
                                     long long t_rows, long long row_bytes,
                                     int span) {
  const int row = blockIdx.x;
  const int b = row / span;
  const int t = row - b * span;
  long long s = starts[b];
  if (s < 0) s += t_rows;
  const long long hi = t_rows - span;
  s = s < 0 ? 0 : (s > hi ? hi : s);
  const V* src = reinterpret_cast<const V*>(series + (s + t) * row_bytes);
  V* dst = reinterpret_cast<V*>(out + static_cast<long long>(row) * row_bytes);
  const long long n = row_bytes / static_cast<long long>(sizeof(V));
  for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

template <typename V>
static int launch(const void* series, const int* starts, void* out,
                  long long t_rows, long long row_bytes, int batch, int span,
                  int threads, cudaStream_t stream) {
  window_gather_kernel<V><<<batch * span, threads, 0, stream>>>(
      static_cast<const char*>(series), starts, static_cast<char*>(out),
      t_rows, row_bytes, span);
  return static_cast<int>(cudaGetLastError());
}

// series: [t_rows, row_bytes] bytes, starts: [batch] int32,
// out: [batch, span, row_bytes] bytes, all on the current device, launched
// on `stream`.  Requires span <= t_rows.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int window_gather(const void* series, const int* starts, void* out,
                             long long t_rows, long long row_bytes, int batch,
                             int span, int threads, void* stream) {
  if (batch <= 0 || span <= 0 || row_bytes <= 0) return 0;
  if (span > t_rows || threads <= 0 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(series) |
                         reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    return launch<uint4>(series, starts, out, t_rows, row_bytes, batch, span, threads, st);
  if (row_bytes % 8 == 0 && addr % 8 == 0)
    return launch<uint2>(series, starts, out, t_rows, row_bytes, batch, span, threads, st);
  if (row_bytes % 4 == 0 && addr % 4 == 0)
    return launch<unsigned int>(series, starts, out, t_rows, row_bytes, batch, span, threads, st);
  return launch<unsigned char>(series, starts, out, t_rows, row_bytes, batch, span, threads, st);
}

extern "C" const char* window_gather_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
