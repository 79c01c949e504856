// One diffusion hop fused with its projection, for Hopper (sm_90a), on the
// tensor cores through `wgmma` in 3xTF32.
//
// Replaces the Pallas TPU kernel `hop_project` in
// src/repro/kernels/diffusion_conv/kernel.py (body `_hop_project_kernel`):
//
//     Z_next[m, b, :] = sum_n S[m, n] · Z[n, b, :]        S [N, N], Z [N, B, C]
//     Y_next[m, b, :] = Y[m, b, :] + Z_next[m, b, :] @ W  W [C, H], Y [N, B, H]
//
// fp32 in and out, fp32 accuracy.  The TPU kernel carried the reduction over
// node blocks across sequential grid steps; here the whole reduction over n
// is a loop inside one block.
//
// Bound.  Operations: 2·N²·B·C for the hop plus 2·N·B·C·H for the
// projection.  Bytes: S read once, Z and Y read once, Z_next and Y_next
// written once: 4·(N² + 2·N·B·C + 2·N·B·H + C·H).  At the forecast shape
// (N = 2716, B = 32, C = 66, H = 128) that is 32.6 GFLOP against 164 MB, far
// above the ridge of every fp32 route.  One TF32 product keeps 10 mantissa
// bits and loses the fp32 tolerance, so the fastest route that keeps fp32
// accuracy is 3xTF32, a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with
// x_hi = tf32_rna(x) and x_lo = tf32_rna(x − x_hi), accumulated in fp32:
// three TF32 products at 495 TFLOP/s, 0.196 ms there.  Only `wgmma` reaches
// the tensor cores' full rate, so the kernel is bound by `wgmma` issue.
//
// Design.  The hop is the GEMM [N, N] · [N, B·C] (hop_gemm.cu's main loop)
// with a per-batch-element epilogue, in one kernel and one launch.
//   - Tiles.  A tile is 128 rows of S by NB whole batch elements of Z, NB·C
//     contiguous floats of each node row of Z, BN = 136 columns wide, zeros
//     past them; NB = min(B, 136 / C).  Where the whole batch fits 72
//     columns (a batch of one), the narrow tile of BN = 72 halves the idle
//     products.  At the forecast shape (N = 2716, B = 32, C = 66) NB = 2:
//     132 of 136 columns, 22 row tiles x 16 = 352 tiles, 2.67 waves of 132
//     SMs.  NB = 3 (200 columns, 242 tiles, 1.83 waves) would need 100 + 100
//     accumulator registers a consumer thread and 3 x 67.6 KB stages, past
//     the register file beside the loaders.
//   - One persistent block of 512 threads an SM.  Warpgroups 0 and 1 load:
//     thread 0 asks TMA for the S tile [128 x 32], 128-byte swizzled (or,
//     where N % 4 != 0, 128 threads copy it with cp.async), and every loader
//     thread reads its share of the Z tile [32 x BN] (one K row, BN / 8
//     columns) from device memory into registers, splits it into hi and lo
//     TF32 and stores both into K-major planes, 128-byte swizzled, of the
//     same stage of an mbarrier ring of four.  So Z is split inside the
//     kernel: no split pass and no planes in device memory.  The stores
//     reach `wgmma` through fence.proxy.async, and each loader warp arrives
//     once.  (A ring of raw Z tiles by TMA, converted from shared memory,
//     measured slower: it adds a write and a read of every tile to the
//     shared memory that `wgmma`'s B reads already half fill.)
//   - S is the A operand from registers: each consumer thread reads its
//     fragment of the S tile and splits it there.  Warpgroups 2 and 3 own
//     64 rows each and issue a_lo·b_hi, a_hi·b_lo, a_hi·b_hi (the small
//     terms first) as three m64nBNk8 `wgmma`s per 8 of K.  Each 32-deep
//     stage goes to a fresh accumulator, added to nearest into the tile's
//     fp32 sum in registers: the tensor cores truncate as they accumulate,
//     and over K = N that drift fails fp32's tolerance.
//   - Epilogue.  Z_next is stored from registers.  The tile is then staged
//     in shared memory over the ring (the loaders wait at a named barrier
//     before the next tile), W's 64-column chunk is split once a tile into
//     K-major hi and lo planes, and Y_next = Y + Z_tile @ W runs on `wgmma`
//     in 3xTF32 as the main loop does: batch element bi's A operand is tile
//     columns bi·C .. bi·C + CP − 1 (CP = C rounded up to 8), from
//     registers, against W's rows zero past C; a fresh accumulator each 32
//     of K.  Y is read once and Y_next written once.
// C ≤ 128 (wider C runs as column tiles in kernel.py).  Forward only, as the
// TPU kernel.  The launch runs on the caller's current device and stream.
// What still bounds it: `wgmma`'s B reads, the S tile and Z's planes share
// shared memory's bandwidth; the epilogue's traffic to device memory (Y,
// Y_next, Z_next) does not overlap the next tile's products; the last wave
// is two thirds full and the last row tile holds N mod 128 live rows.

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "mma.cuh"
#include "tma.cuh"

namespace {

constexpr int kBM = 128;       // rows of S a tile: two consumer warpgroups of 64
constexpr int kBK = 32;        // nodes a stage: one 128-byte swizzle row of fp32
constexpr int kThreads = 512;  // warpgroups 0 and 1 load, 2 and 3 compute
constexpr int kLoaders = 256;
constexpr int kStages = 4;     // stages in the ring of S tiles and Z planes
constexpr int kWide = 136;     // columns of the wide tile; the narrow one has 72
constexpr int kNarrow = 72;
constexpr uint32_t kABytes = kBM * kBK * 4;  // the raw S tile of a stage
constexpr int kEmptyCount = 8;  // one arrival per consumer warp
constexpr int kHB = 64;         // H columns a projection pass
constexpr int kMaxC = 128;
constexpr int kKC = kMaxC / kBK;  // 32-deep chunks of W's rows
constexpr int kBarRing = 1;  // named barrier: the epilogue is done with the ring
constexpr int kBarEpi = 2;   // named barrier of the two consumer warpgroups
constexpr int kMaxDevices = 64;

// Shared memory of a tile BN columns wide.  The ring's stages hold the raw S
// tile and Z's hi and lo planes; the epilogue reuses the ring for the
// staged Z_next tile [128][TP] and W's hi and lo planes of 64 columns.
template <int BN>
struct Layout {
  static constexpr uint32_t kPlane = BN * kBK * 4;  // one B plane
  static constexpr uint32_t kStage = kABytes + 2 * kPlane;
  // Z_next tile pitch ≡ 4 (mod 32), so the A fragment reads hit 32 banks,
  // and at least BN + 8: the last element's operand reads 7 columns past it.
  static constexpr int kTP = (BN + 8 + 27) / 32 * 32 + 4;
  static constexpr uint32_t kRing = kStages * kStage;
  static constexpr uint32_t kWOff = 4u * kBM * kTP;  // W's planes, after the tile
  static constexpr uint32_t kWPlane = kKC * kHB * kBK * 4;
  static constexpr uint32_t kEpi = kWOff + 2 * kWPlane;
  static constexpr uint32_t kBytes = kRing > kEpi ? kRing : kEpi;
  static constexpr size_t kSmem = kBytes + 2 * kStages * sizeof(uint64_t) + 1024;  // + alignment
  static_assert(BN % 8 == 0 && kStage % 1024 == 0,
                "128-byte swizzled planes start on 1024-byte boundaries");
  static_assert(kSmem <= 232448, "over the 227 KB a block can use");
  static_assert(kWOff % 1024 == 0, "W's planes start on a 1024-byte boundary");
};

// d = a · B, or d += a · B where `accumulate`, over one k8 step: m64nBNk8,
// A (tf32) from registers, B from shared memory through `desc`.
__device__ __forceinline__ void wgmma_n72(float (&d)[36], const uint32_t (&a)[4],
                                      uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n136(float (&d)[68], const uint32_t (&a)[4],
                                      uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67"
      "}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  if constexpr (BN == kWide) wgmma_n136(d, a, desc, accumulate);
  else wgmma_n72(d, a, desc, accumulate);
}

// Float offset of element (m, k) of a stage's S tile [128 rows x 32 of K]:
// row m's 32 floats are one 128-byte row, its 16-byte chunks XOR-swizzled by
// m % 8, so a warp's fragment reads (rows g and g + 8, columns t and t + 4
// of an 8-deep step; lane = 4·g + t) hit 32 distinct banks.
__device__ __forceinline__ int a_offset(int m, int k) {
  return m * 32 + (((k >> 2) ^ (m & 7)) << 2) + (k & 3);
}

// The loader's share of a stage's S tile, where TMA cannot take S (n % 4 != 0
// or S not 16-byte aligned): S[m0 + m, k0 + k] by 4-byte copies, zero past
// n, at a_offset(m, k), as TMA's 128-byte swizzle puts it.
__device__ __forceinline__ void load_s(uint32_t dst, const float* __restrict__ s, int n,
                                       int m0, int k0, int t) {
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {  // 4,096 floats, 32 a thread
    const int i = t + 128 * j, m = i >> 5, k = i & 31;
    const int gm = m0 + m, gk = k0 + k;
    const bool ok = gm < n && gk < n;
    mma::cp_async_4(dst + 4 * a_offset(m, k),
                    ok ? s + static_cast<long long>(gm) * n + gk : s, ok ? 4 : 0);
  }
}

// The A fragment of K step kk (columns 8·kk + t and + 4, rows r and r + 8 of
// the tile) from a stage's S tile, split into hi and lo TF32.
__device__ __forceinline__ void load_frag(const float* tile, int r, int t, int kk,
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int k = 8 * kk + t;
  mma::split_tf32(tile[a_offset(r, k)], hi[0], lo[0]);
  mma::split_tf32(tile[a_offset(r + 8, k)], hi[1], lo[1]);
  mma::split_tf32(tile[a_offset(r, k + 4)], hi[2], lo[2]);
  mma::split_tf32(tile[a_offset(r + 8, k + 4)], hi[3], lo[3]);
}

// The A fragment of rows (g, g + 8) and columns (t, t + 4) at `p` (the
// element (g, t)) of a row-major fp32 tile of pitch `pitch`, split.
__device__ __forceinline__ void load_a_rows(const float* p, int pitch, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  mma::split_tf32(p[0], hi[0], lo[0]);
  mma::split_tf32(p[8 * pitch], hi[1], lo[1]);
  mma::split_tf32(p[4], hi[2], lo[2]);
  mma::split_tf32(p[8 * pitch + 4], hi[3], lo[3]);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
hop_project_kernel(const __grid_constant__ CUtensorMap s_map, const float* __restrict__ s,
                   const float* __restrict__ z, const float* __restrict__ w,
                   const float* __restrict__ y, float* __restrict__ z_out,
                   float* __restrict__ y_out, int n, int bsz, int c, int h, int nb,
                   int col_tiles, int tiles, int s_tma, int pairs) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mma::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* smem = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t bars = base + L::kBytes;  // full[kStages], empty[kStages]
  const int tid = threadIdx.x;
  if (tid == 0) {
    // A stage is full once its S tile has landed (TMA's bytes and one
    // arrival with them, or 128 loader threads' cp.asyncs) and every loader
    // warp has written its share of Z's planes.
    for (int st = 0; st < kStages; ++st) {
      mma::mbarrier_init(bars + 8 * st, (s_tma ? 1 : 128) + kLoaders / 32);
      mma::mbarrier_init(bars + 8 * (kStages + st), kEmptyCount);
    }
    mma::mbarrier_init_fence();
  }
  __syncthreads();
  const int kblocks = (n + kBK - 1) / kBK;
  const long long zrow = static_cast<long long>(bsz) * c;  // stride of a node in Z

  if (tid < kLoaders) {  // ----------------------------------------- loaders
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    // The block's jobs: its tiles, blockIdx.x + i·gridDim.x, each kblocks
    // stages of 32 nodes.  The ring waits at each new tile for the epilogue,
    // which reuses it.
    const int jobs = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * kblocks;
    // This thread's share of a stage's Z tile: K row kr, tile columns cq +
    // 8·p.  Element (column j, K k) of a plane sits at float j·32 + (((k /
    // 4) ^ (j % 8)) · 4) + k % 4 (128-byte swizzle), so a warp's stores hit
    // 32 banks, and its loads read 4 rows of 32 bytes.
    const int lane = tid & 31, wq = tid >> 5;
    const int kr = 4 * wq + (lane >> 3), cq = lane & 7;
    const int off = 32 * cq + ((wq ^ cq) << 2) + (lane >> 3);
    int stage = 0;
    uint32_t phase = 0;
    for (int q = 0; q < jobs; ++q) {
      const int tile = blockIdx.x + q / kblocks * gridDim.x, kb = q % kblocks, k0 = kb * kBK;
      const int m0 = tile / col_tiles * kBM, b0 = tile % col_tiles * nb;
      // The share of job q's Z tile, in flight while the stage frees: zero
      // past n and past the block's batch elements.
      const int k = k0 + kr, lspan = min(nb, bsz - b0) * c;
      const float* zr = z + (k < n ? k * zrow : 0) + static_cast<long long>(b0) * c;
      float v[BN / 8];
#pragma unroll
      for (int p = 0; p < BN / 8; ++p) v[p] = k < n && cq + 8 * p < lspan ? zr[cq + 8 * p] : 0.f;
      if (kb == 0 && q > 0) mma::bar_sync(kBarRing, kThreads);  // the epilogue left the ring
      const uint32_t full = bars + 8 * stage, dst = base + stage * L::kStage;
      mma::wait_parity(bars + 8 * (kStages + stage), phase ^ 1);  // consumers done with it
      if (s_tma) {
        if (tid == 0) {
          mma::mbarrier_expect(full, kABytes);
          tma::load_2d(dst, &s_map, k0, m0, full);
        }
      } else if (tid < 128) {
        load_s(dst, s, n, m0, k0, tid);
        mma::cp_async_arrive(full);
      }
      float* hi = smem + (stage * L::kStage + kABytes) / 4;
      float* lo = hi + L::kPlane / 4;
#pragma unroll
      for (int p = 0; p < BN / 8; ++p) {
        uint32_t a, b;
        mma::split_tf32(v[p], a, b);
        hi[256 * p + off] = __uint_as_float(a);
        lo[256 * p + off] = __uint_as_float(b);
      }
      mma::fence_proxy_async();
      __syncwarp();
      if (lane == 0) mma::mbarrier_arrive(full);
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // exit with no copy in flight
    return;
  }

  // --------------------------------------------------------------- consumers
  // Two accumulators of BN / 2 floats a thread: the tensor cores' partial
  // sum of one stage and the tile's sum, added to once a stage, to nearest.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
  const int lane = tid & 31, g = lane >> 2, t = lane & 3, ct = tid - kLoaders;
  const int r = 16 * (ct >> 5) + g;  // fragment rows r, r + 8 (16 a consumer warp)
  const int cp = (c + 7) & ~7;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / col_tiles * kBM, b0 = tile % col_tiles * nb;
    const int live_b = min(nb, bsz - b0), lspan = live_b * c;
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    uint32_t ahi[2][4], alo[2][4];
    mma::wait_parity(bars + 8 * stage, phase);
    load_frag(smem + stage * (L::kStage / 4), r, t, 0, ahi[0], alo[0]);
    for (int kb = 0; kb < kblocks; ++kb) {
      const uint64_t dhi = mma::desc_sw128(base + stage * L::kStage + kABytes);
      const uint64_t dlo = dhi + (L::kPlane >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma::wgmma_fence();
        wgmma_tile<BN>(part, alo[kk & 1], dhi + 2 * kk, kk > 0);  // the small terms first
        wgmma_tile<BN>(part, ahi[kk & 1], dlo + 2 * kk, 1);
        wgmma_tile<BN>(part, ahi[kk & 1], dhi + 2 * kk, 1);
        mma::wgmma_commit();
        if (kk < 3) {
          mma::wgmma_wait<1>();  // every product but these three is done
          load_frag(smem + stage * (L::kStage / 4), r, t, kk + 1, ahi[(kk + 1) & 1],
                    alo[(kk + 1) & 1]);
        }
      }
      mma::wgmma_wait<0>();
      mma::fence_regs(part);
      if (lane == 0) mma::mbarrier_arrive(bars + 8 * (kStages + stage));  // the stage is free
      if (++stage == kStages) { stage = 0; phase ^= 1; }
      if (kb + 1 < kblocks) {
        mma::wait_parity(bars + 8 * stage, phase);
        load_frag(smem + stage * (L::kStage / 4), r, t, 0, ahi[0], alo[0]);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      mma::fence_regs(part);
    }

    // Z_next out from registers: acc[4j + e] is row r + 8·(e / 2), column
    // 8j + 2t + e % 2; the block's batch elements are lspan contiguous
    // floats of each row, written in pairs where those are 8-byte aligned
    // (pairs & 2: Z_next's base is).
    const bool zpairs = (pairs & 2) && ((zrow | static_cast<long long>(b0) * c) & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gr = m0 + r + 8 * half;
      if (gr >= n) continue;
      float* row = z_out + gr * zrow + static_cast<long long>(b0) * c;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if (zpairs && col + 1 < lspan) {
          *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        } else {
          if (col < lspan) row[col] = v0;
          if (col + 1 < lspan) row[col + 1] = v1;
        }
      }
    }

    // The tile to shared memory over the ring, once both warpgroups are
    // done with it; columns BN .. BN + 7 zero (the last element's operand
    // reads up to CP − C past its columns).
    mma::bar_sync(kBarEpi, 256);
    float* tt = smem;  // [kBM][kTP]
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      tt[r * L::kTP + col] = acc[4 * j];
      tt[r * L::kTP + col + 1] = acc[4 * j + 1];
      tt[(r + 8) * L::kTP + col] = acc[4 * j + 2];
      tt[(r + 8) * L::kTP + col + 1] = acc[4 * j + 3];
    }
    tt[r * L::kTP + BN + 2 * t] = tt[r * L::kTP + BN + 2 * t + 1] = 0.f;
    tt[(r + 8) * L::kTP + BN + 2 * t] = tt[(r + 8) * L::kTP + BN + 2 * t + 1] = 0.f;

    // Y_next = Y + Z_tile @ W, per batch element and 64 columns of H, on
    // `wgmma` in 3xTF32 as the main loop: A, the element's columns of each
    // warpgroup's 64 staged rows, from registers; B, W's 64 columns as hi and
    // lo planes [kKC][64][32] (K-major, 128-byte swizzled, zero past c and
    // h), split once a chunk; a fresh accumulator each 32 of K.
    float* wp = smem + L::kWOff / 4;
    const uint64_t dw = mma::desc_sw128(base + L::kWOff);
    for (int h0 = 0; h0 < h; h0 += kHB) {
      float wv[kKC * kBK * kHB / 256];  // every thread's loads in flight at once
#pragma unroll
      for (int it = 0; it < kKC * kBK * kHB / 256; ++it) {
        const int i = ct + 256 * it, kk = i / kHB, hh = i % kHB;
        wv[it] = kk < c && h0 + hh < h ? w[kk * h + h0 + hh] : 0.f;
      }
      mma::bar_sync(kBarEpi, 256);  // every product of the previous chunk is done
#pragma unroll
      for (int it = 0; it < kKC * kBK * kHB / 256; ++it) {
        const int i = ct + 256 * it, kk = i / kHB, hh = i % kHB;
        const int off = (kk >> 5) * (kHB * kBK) + hh * kBK +
                        ((((kk & 31) >> 2) ^ (hh & 7)) << 2) + (kk & 3);
        uint32_t a, b;
        mma::split_tf32(wv[it], a, b);
        wp[off] = __uint_as_float(a);
        wp[off + L::kWPlane / 4] = __uint_as_float(b);
      }
      mma::fence_proxy_async();
      mma::bar_sync(kBarEpi, 256);
      for (int bi = 0; bi < live_b; ++bi) {
        // pa[4j + e] is row r + 8·(e / 2), column h0 + 8j + 2t + e % 2: Y's
        // pairs of columns read and written as one 8-byte access where H is
        // even and Y and Y_next 8-byte aligned (pairs & 1).
        float yv[kHB / 2], ya[kHB / 2], pa[kHB / 2];
        auto y_at = [&](int i) {
          const int gr = m0 + r + 8 * ((i >> 1) & 1), hh = h0 + 8 * (i >> 2) + 2 * t + (i & 1);
          return gr < n && hh < h ? (gr * static_cast<long long>(bsz) + b0 + bi) * h + hh : -1LL;
        };
#pragma unroll
        for (int i = 0; i < kHB / 2; i += 2) {
          const long long o = y_at(i);
          if (pairs & 1) {
            const float2 v =
                o >= 0 ? *reinterpret_cast<const float2*>(y + o) : make_float2(0.f, 0.f);
            yv[i] = v.x;
            yv[i + 1] = v.y;
          } else {
            const long long o1 = y_at(i + 1);
            yv[i] = o >= 0 ? y[o] : 0.f;
            yv[i + 1] = o1 >= 0 ? y[o1] : 0.f;
          }
          ya[i] = ya[i + 1] = 0.f;
        }
        // Whole 32-deep chunks of K, then its last 8-deep steps one by one.
        const float* ta = tt + r * L::kTP + bi * c + t;
        for (int k0 = 0; k0 < cp;) {
          const int steps = cp - k0 >= kBK ? 4 : 1;
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kk < steps) load_a_rows(ta + k0 + 8 * kk, L::kTP, ah[kk], al[kk]);
          const uint64_t dhi = dw + ((k0 / kBK) * (kHB * kBK * 4) >> 4) + 2 * (k0 % kBK / 8);
          const uint64_t dlo = dhi + (L::kWPlane >> 4);
          mma::wgmma_fence();
          if (steps == 4) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_n64(pa, al[kk], dhi + 2 * kk, kk > 0);
              wgmma_n64(pa, ah[kk], dlo + 2 * kk, 1);
              wgmma_n64(pa, ah[kk], dhi + 2 * kk, 1);
            }
          } else {
            wgmma_n64(pa, al[0], dhi, 0);
            wgmma_n64(pa, ah[0], dlo, 1);
            wgmma_n64(pa, ah[0], dhi, 1);
          }
          mma::wgmma_commit();
          mma::wgmma_wait<0>();
          mma::fence_regs(pa);
#pragma unroll
          for (int i = 0; i < kHB / 2; ++i) ya[i] += pa[i];
          mma::fence_regs(pa);
          k0 += 8 * steps;
        }
#pragma unroll
        for (int i = 0; i < kHB / 2; i += 2) {
          const long long o = y_at(i);
          if (pairs & 1) {
            if (o >= 0)
              *reinterpret_cast<float2*>(y_out + o) =
                  make_float2(yv[i] + ya[i], yv[i + 1] + ya[i + 1]);
          } else {
            const long long o1 = y_at(i + 1);
            if (o >= 0) y_out[o] = yv[i] + ya[i];
            if (o1 >= 0) y_out[o1] = yv[i + 1] + ya[i + 1];
          }
        }
      }
    }
    if (tile + static_cast<int>(gridDim.x) < tiles)
      mma::bar_arrive(kBarRing, kThreads);  // the loader may refill the ring
  }
}

template <int BN>
int launch(const float* s, const float* z, const float* w, const float* y, float* z_out,
           float* y_out, int n, int bsz, int c, int h, int nb, int sms, cudaStream_t stream) {
  auto kernel = hop_project_kernel<BN>;
  // The shared-memory limit holds for the device's context: set it on the
  // first launch on each device, not on every one.
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Layout<BN>::kSmem));
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  // S's tiles by TMA where its rows are 16-byte aligned: [128 rows x 32
  // nodes] boxes, 128-byte swizzled (a_offset).
  const bool s_tma = n % 4 == 0 && reinterpret_cast<std::uintptr_t>(s) % 16 == 0;
  CUtensorMap s_map = {};
  if (s_tma) {
    const tma::EncodeTiled encode = tma::encode_tiled();
    if (!encode) return tma::kErrNoEncoder;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(kBM)};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(s), dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return tma::kErrTensorMap;
  }
  const auto at8 = [](const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 8 == 0; };
  const int pairs = (h % 2 == 0 && at8(y) && at8(y_out) ? 1 : 0) | (at8(z_out) ? 2 : 0);
  const int col_tiles = (bsz + nb - 1) / nb;
  const long long tiles = static_cast<long long>((n + kBM - 1) / kBM) * col_tiles;
  if (tiles > (1LL << 30)) return cudaErrorInvalidValue;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  kernel<<<grid, kThreads, Layout<BN>::kSmem, stream>>>(
      s_map, s, z, w, y, z_out, y_out, n, bsz, c, h, nb, col_tiles, static_cast<int>(tiles),
      s_tma ? 1 : 0, pairs);
  return cudaGetLastError();
}

}  // namespace

// s: [n, n], z: [n, bsz, c], w: [c, h], y: [n, bsz, h], all contiguous fp32;
// z_out: [n, bsz, c], y_out: [n, bsz, h]; all on the current device,
// launched on `stream` over at most `sms` blocks.  c <= 128.
// Returns 0, a cudaError_t, or one of tma.cuh's kErr codes (see
// hop_project_error).
extern "C" int hop_project_f32(const float* s, const float* z, const float* w,
                               const float* y, float* z_out, float* y_out,
                               int n, int bsz, int c, int h, int sms, void* stream) {
  if (n <= 0 || bsz <= 0) return 0;
  if (c <= 0 || c > kMaxC || h < 0 || sms <= 0 || static_cast<long long>(bsz) * c > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  // NB whole batch elements a tile, as many as the wide tile holds; the
  // narrow tile where the whole batch fits it (a batch of one or two).
  const int nb = bsz < kWide / c ? bsz : kWide / c;
  const auto st = static_cast<cudaStream_t>(stream);
  return nb == bsz && nb * c <= kNarrow
             ? launch<kNarrow>(s, z, w, y, z_out, y_out, n, bsz, c, h, nb, sms, st)
             : launch<kWide>(s, z, w, y, z_out, y_out, n, bsz, c, h, nb, sms, st);
}

extern "C" const char* hop_project_error(int code) {
  if (code == tma::kErrNoEncoder) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == tma::kErrTensorMap) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
