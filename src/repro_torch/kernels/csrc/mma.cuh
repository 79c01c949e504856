// Thin inline-PTX wrappers that the kernels share (built for sm_90a): the
// warp-level tensor-core instructions of flash_attention.cu (sm_80 and
// later), `cp.async` (flash_attention.cu, linear_scan.cu and the hop
// kernels), the mbarriers and bulk copies of window_gather.cu (sm_90), and
// the waits, fences and `wgmma` descriptors of the warp-specialised rings of
// hop_gemm.cu and hop_project.cu.
//
// Fragment layouts of one warp (lane = 4·g + t, g = lane / 4, t = lane % 4),
// as the PTX ISA defines them for mma.sync (a warp's tf32 A fragment is also
// what `wgmma` takes from registers for its 16 rows of a warpgroup's 64):
//   m16n8k16 bf16  A 16x16 (row): a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1),
//                                 a2 (g, 2t+8..2t+9), a3 (g+8, 2t+8..2t+9)
//                  B 16x8 (col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   m16n8k8 tf32   A 16x8 (row):  a0 (g, t), a1 (g+8, t), a2 (g, t+4),
//                                 a3 (g+8, t+4)
//                  B 8x8 (col):   b0 (k t, n g), b1 (k t+4, n g)
//   C/D 16x8 f32 (both):          d0, d1 (g, 2t..2t+1), d2, d3 (g+8, 2t..2t+1)
// The low 16 bits of a packed bf16 pair hold the lower column (or k) index.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The products are plain (not volatile) asm: they touch registers only, so
// the compiler may schedule them around the loads that feed them.

// d += a · b, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the 16-byte
// row addresses of matrix i, and register i receives matrix i's
// (row g, columns 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// As ldmatrix_x4, transposed: register i receives matrix i's
// (rows 2t..2t+1, column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Asynchronous global -> shared copies.  The first `src_bytes` bytes come
// from `src`, the rest of the destination is zero-filled; with src_bytes = 0
// nothing is read.  16-byte copies bypass L1 (.cg); 4-byte ones go through it.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbarrier_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Make initialised barriers visible to the bulk copy engine.
__device__ __forceinline__ void mbarrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival, and `bytes` more to land on the barrier before its phase ends.
__device__ __forceinline__ void mbarrier_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// ------------------------------------------------------------ bulk copies
// An L2 policy that evicts first the lines it tags: for data read once.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// global -> shared, `bytes` (a multiple of 16, both addresses 16-byte
// aligned) counted on `bar` when they land; the lines read carry `policy`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy) : "memory");
}

// shared -> global, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N bulk store groups of this thread still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Until every bulk store group of this thread has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------- warp-specialised wgmma rings
// A spin on an mbarrier that outlasts this many clocks (about 10 s) is a
// fault: trap rather than hang the card.
constexpr long long kSpinLimit = 20000000000LL;

// Until the barrier's phase of the given parity has completed, or trap.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// One arrival on `bar` once every cp.async this thread issued so far has
// landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// This thread's writes to shared memory, visible to the async proxy (the
// operands `wgmma` reads there) once a barrier orders them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers (0 is __syncthreads): `count` threads, a multiple of 32.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// The `wgmma` descriptor of a K-major tile at shared address `addr`, 128-byte
// swizzled: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused in this mode.  Adding 2 steps 32 bytes (8 fp32)
// along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero:
// bit for bit what cvt.rna.tf32.f32 gives for finite x.  Adding half a TF32
// ulp to the magnitude bits and dropping the low 13 takes two integer
// operations, cheaper on this card than the conversion instruction.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ≈ hi + lo with hi = tf32(x) and lo = tf32(x - hi): the operands of the
// 3xTF32 product a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Two floats as a bf16 pair (round to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma
