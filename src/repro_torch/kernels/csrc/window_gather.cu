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
// Bound.  Pure data movement: each output byte is read once and written once,
// 2·B·span·C·itemsize bytes over device-memory bandwidth.  At the main-path
// shape (series [8640, 5432] f32, B = 32, span = 24) that is 33.4 MB,
// 0.00996 ms at 3.35 TB/s; a well-made copy reaches about 90 % of that.
//
// Design.  A window's span rows are contiguous in the series and in `out`,
// so the gather is B contiguous copies of span·row_bytes bytes each.  The
// launcher picks one of two routes from the call's shape
// (kernels/window_gather/kernel.py, `launch_shape`); both copy raw bytes, so
// any dtype works.
//
// - Bulk route, for rows whose width and both base addresses are multiples
//   of 16 bytes (the main path's 21,728-byte rows): Hopper's bulk copy
//   engine.  A persistent grid of at most one block per SM takes equal,
//   contiguous shares of the B·span·row_bytes output bytes (to 128 bytes),
//   cut into pieces of at most `piece` bytes that do not cross a window's
//   end.  One thread of the block walks its share through a ring of kRing
//   shared-memory buffers: `cp.async.bulk` global -> shared completes on the
//   buffer's mbarrier, `cp.async.bulk` shared -> global writes the piece out,
//   and `cp.async.bulk.wait_group.read` frees a buffer for the next load.  So
//   kRing loads are in flight a block (32 KB with 4 KB pieces, 4.2 MB over
//   132 SMs: enough to cover the memory latency, few enough that pieces
//   land in order and the writes overlap the reads), and no thread moves a
//   byte itself.  The loads tag the series lines evict-first in L2: each is
//   read once, and the output stays in L2 for the model that reads it next.
// - Vector route, for other rows (C = 130 float32 is 520 bytes, uint8 and
//   odd widths): one block of kVectorThreads per output row (b, t); the
//   vector width is the widest of 16, 8, 4 or 1 bytes that divides the row
//   and both base pointers; neighbouring threads move neighbouring vectors,
//   so every load and store is coalesced, and the loop bound masks the
//   ragged end of the row.
//
// Nothing is padded.  The start rule is applied per window, as the oracle does.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kVectorThreads = 256;
constexpr int kRing = 8;               // shared-memory buffers of the bulk route
constexpr int kMaxPiece = 28 * 1024;   // kRing of them fit the SM's 227 KB

__device__ __forceinline__ long long first_row(const int* starts, long long b,
                                               long long t_rows, int span) {
  long long s = starts[b];
  if (s < 0) s += t_rows;
  const long long hi = t_rows - span;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

template <typename V>
__global__ void window_gather_vector(const char* __restrict__ series,
                                     const int* __restrict__ starts,
                                     char* __restrict__ out, long long t_rows,
                                     long long row_bytes, int span) {
  const int row = blockIdx.x;
  const int b = row / span;
  const int t = row - b * span;
  const long long s = first_row(starts, b, t_rows, span);
  const V* src = reinterpret_cast<const V*>(series + (s + t) * row_bytes);
  V* dst = reinterpret_cast<V*>(out + static_cast<long long>(row) * row_bytes);
  const long long n = row_bytes / static_cast<long long>(sizeof(V));
  for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// A walk over the pieces of one block's share: `pos` is the next piece's
// first byte in `out`, `end` the end of the window holding it, and `src`
// the series byte that `pos` copies.  Advancing costs no division.
struct Walk {
  long long pos, end;
  const char* src;
  long long w;

  __device__ __forceinline__ uint32_t length(int piece, long long hi) const {
    long long stop = pos + piece;
    if (stop > end) stop = end;
    if (stop > hi) stop = hi;
    return static_cast<uint32_t>(stop - pos);
  }
};

__global__ void __launch_bounds__(32) window_gather_bulk(
    const char* __restrict__ series, const int* __restrict__ starts,
    char* __restrict__ out, long long t_rows, long long row_bytes, int span, int piece,
    long long total) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kRing];
  if (threadIdx.x != 0) return;
  // This block's share: bytes [lo, hi) of the B windows laid end to end, as
  // `out` holds them, cut on 128-byte lines so that no store shares a
  // sector with another block's; then into pieces at most `piece` long that
  // do not cross a window's end.
  const long long lines = total / 128;
  const long long lo = blockIdx.x * lines / gridDim.x * 128;
  const long long hi =
      blockIdx.x + 1 == gridDim.x ? total : (blockIdx.x + 1LL) * lines / gridDim.x * 128;
  const long long window = span * row_bytes;
  const long long w0 = lo / window;
  Walk loads{lo, (w0 + 1) * window,
             series + first_row(starts, w0, t_rows, span) * row_bytes + (lo - w0 * window),
             w0};
  Walk stores = loads;
  for (int s = 0; s < kRing; ++s) mma::mbarrier_init(mma::smem_addr(&full[s]), 1);
  mma::mbarrier_init_fence();

  // Load m goes to buffer m % kRing, up to kRing pieces ahead of the stores.
  // The series rows are read once: they leave L2 first, and the output
  // (which the model reads next) stays.
  const uint64_t read_once = mma::l2_evict_first();
  const auto load = [&](int buf) {
    const uint32_t bytes = loads.length(piece, hi);
    const uint32_t bar = mma::smem_addr(&full[buf]);
    mma::mbarrier_expect(bar, bytes);
    mma::bulk_load(mma::smem_addr(ring + buf * piece), loads.src, bytes, bar, read_once);
    loads.pos += bytes;
    loads.src += bytes;
    if (loads.pos == loads.end && loads.pos < hi) {
      ++loads.w;
      loads.end += window;
      loads.src = series + first_row(starts, loads.w, t_rows, span) * row_bytes;
    }
  };
  for (int m = 0; m < kRing && loads.pos < hi; ++m) load(m);
  for (int j = 0; stores.pos < hi; ++j) {
    const int buf = j % kRing;
    mma::mbarrier_wait(mma::smem_addr(&full[buf]), (j / kRing) & 1);
    const uint32_t bytes = stores.length(piece, hi);
    mma::bulk_store(out + stores.pos, mma::smem_addr(ring + buf * piece), bytes);
    stores.pos += bytes;
    if (stores.pos == stores.end) stores.end += window;
    // Refill the buffer of piece j - 1 (load j - 1 + kRing) once its store
    // has read it.
    if (j >= 1 && loads.pos < hi) {
      mma::bulk_wait_read<1>();
      load((j - 1) % kRing);
    }
  }
  mma::bulk_wait_all();
}

template <typename V>
int launch_vector(const void* series, const int* starts, void* out, long long t_rows,
                  long long row_bytes, int rows, int span, cudaStream_t stream) {
  window_gather_vector<V><<<rows, kVectorThreads, 0, stream>>>(
      static_cast<const char*>(series), starts, static_cast<char*>(out), t_rows,
      row_bytes, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// series: [t_rows, row_bytes] bytes, starts: [batch] int32,
// out: [batch, span, row_bytes] bytes, all on the current device, launched
// on `stream`.  Requires span <= t_rows.  piece = 0 takes the vector route;
// piece > 0 takes the bulk route with pieces of at most `piece` bytes (a
// multiple of 16, at most 28 KB) over `blocks` persistent blocks (at most
// one per 16 output bytes), and needs row_bytes and both base pointers to be
// multiples of 16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int window_gather(const void* series, const int* starts, void* out,
                             long long t_rows, long long row_bytes, int batch,
                             int span, int piece, int blocks, void* stream) {
  if (batch <= 0 || span <= 0 || row_bytes <= 0) return 0;
  if (span > t_rows || static_cast<long long>(batch) * span > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(series) |
                         reinterpret_cast<uintptr_t>(out);
  if (piece > 0) {
    const long long total = batch * span * row_bytes;
    if (piece % 16 || piece > kMaxPiece || row_bytes % 16 || addr % 16 || blocks <= 0 ||
        blocks > total / 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = kRing * piece;
    cudaError_t err = cudaFuncSetAttribute(
        window_gather_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_gather_bulk<<<blocks, 32, smem, st>>>(
        static_cast<const char*>(series), starts, static_cast<char*>(out), t_rows,
        row_bytes, span, piece, total);
    return static_cast<int>(cudaGetLastError());
  }
  const int rows = batch * span;
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    return launch_vector<uint4>(series, starts, out, t_rows, row_bytes, rows, span, st);
  if (row_bytes % 8 == 0 && addr % 8 == 0)
    return launch_vector<uint2>(series, starts, out, t_rows, row_bytes, rows, span, st);
  if (row_bytes % 4 == 0 && addr % 4 == 0)
    return launch_vector<unsigned int>(series, starts, out, t_rows, row_bytes, rows, span, st);
  return launch_vector<unsigned char>(series, starts, out, t_rows, row_bytes, rows, span, st);
}

extern "C" const char* window_gather_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
