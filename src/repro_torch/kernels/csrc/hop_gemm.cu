// The diffusion hop of training and its backward, for Hopper (sm_90a), on
// the tensor cores through `wgmma` in 3xTF32:
//
//     forward   Z_k     = S  @ Z_{k-1}      S [N, N] in C order, Z [N, B·C]
//     backward  dZ_{k-1} = Sᵀ @ dZ_k
//
// Replaces no TPU kernel: the JAX package differentiates its hops through
// XLA's products, and the port ran them on cuBLAS, in fp32 on the CUDA
// cores.  It was added because those products hold 87–97 % of a training
// step's device time (PERF.md).
//
// Bound.  Operations: 2·N²·B·C a hop, each way.  Bytes: S read once, Z read
// once and written once: 4·(N² + 2·N·B·C).  At the main-path shapes
// (N = 11,160, B·C = 520–1,024; N = 2,716, B·C = 2,112) that is 130–2,000
// operations a byte, above the ridge of every route.  fp32 on the CUDA cores
// peaks at 67 TFLOP/s.  One TF32 product keeps 10 mantissa bits and loses
// the fp32 tolerance, so the fastest route that keeps fp32 accuracy is
// 3xTF32, a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi with x_hi = tf32_rna(x)
// and x_lo = tf32_rna(x − x_hi), accumulated in fp32: three TF32 products at
// 495 TFLOP/s, 165 TFLOP/s of fp32 products.  Only `wgmma` reaches the
// tensor cores' full rate, so the kernel is bound by `wgmma` issue.
//
// Design.  The product is C[M, cols] = A · B with M = K = N, A = S or Sᵀ
// and B = Z (cols = B·C).
//   - `wgmma` takes 32-bit operands from shared memory only K-major, and
//     the 3xTF32 split needs hi and lo planes of every operand it reads
//     there.  B is the small operand: one pass (`hop_gemm_split_b`) reads Z
//     in whatever strides it has (a transposed input, a slice of a
//     concatenation's gradient) and writes it split and transposed, as
//     K-major hi and lo planes [2][cols][Kp] (Kp = N rounded up to 4, so
//     that every row is 16-byte aligned for TMA).  S is never copied.
//   - A comes from registers, which `wgmma` takes in any order: each
//     consumer thread reads its fragment of the raw fp32 S tile from shared
//     memory and splits it into hi and lo there.  The same code reads S's
//     tile transposed for the backward; the tile's swizzle is chosen per
//     order so that both fragment reads are free of bank conflicts.
//   - A block of 384 threads runs on each SM and walks its tiles of 128
//     rows x BN = 176 columns (persistent).  Warpgroup 0 loads: each of its
//     threads copies a share of the S tile [128 x 32] with cp.async
//     (zero-filled past N, whatever N's alignment) and thread 0 asks TMA for
//     the B planes' hi and lo tiles [BN x 32], 128-byte swizzled, zero-filled
//     past N and cols; an mbarrier ring of kStages holds them.  Warpgroups 1
//     and 2 each own 64 rows: per step of 8 along K they issue
//     a_lo·b_hi, a_hi·b_lo, a_hi·b_hi (the small terms first) as three
//     m64nBNk8 `wgmma`s, and load and split the next step's A fragment
//     while those run.  The two warpgroups share the SMs' tensor cores, so
//     one's waits are the other's turn.
//   - The tensor cores add into their fp32 accumulator with truncation, so
//     over K = 11,160 their sum drifts by thousands of truncations of its
//     own size (4e-5 relative loss gaps against the fp32 reference, 40x the
//     benchmark's limit).  So each stage's 32-deep products go to a fresh
//     accumulator, which is then added, to nearest, into the tile's sum in
//     registers: the error is then fp32's own.  The two accumulators take
//     88 + 88 registers a thread; `setmaxnreg` moves the loader's unused
//     registers to the consumers.
//   - BN = 176 fills whole waves of SMs at every main-path shape: cols
//     520, 528 and 2,112 are 3 and 12 tiles of 176, 1,024 is 6, so the
//     128-row tiles come to 264 or 528 over 132 SMs.
//   - The epilogue stores the accumulator straight from registers, rows
//     past N and columns past cols left out, while warpgroup 0 already
//     loads the next tile.
// What still bounds it: each stage ends in a wait for its products and
// 88 adds a thread; the split pass reads Z and writes twice its bytes;
// each of the three products reads its B tile from shared memory again; the
// last tile row has N mod 128 live rows.

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "mma.cuh"
#include "tma.cuh"

namespace {

constexpr int kBM = 128;       // rows of the product a tile: two consumer warpgroups of 64
constexpr int kBK = 32;        // K a stage: one 128-byte swizzle row of fp32
constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int kBN = 176;       // columns of the product a tile
constexpr int kStages = 3;     // stages in the ring: 3 x 61,440 bytes of shared memory
constexpr uint32_t kABytes = kBM * kBK * 4;  // the raw S tile of a stage
constexpr uint32_t kBBytes = kBN * kBK * 4;  // one B plane's tile
constexpr uint32_t kStageBytes = kABytes + 2 * kBBytes;
constexpr size_t kSmem = kStages * static_cast<size_t>(kStageBytes) +
                         2 * kStages * sizeof(uint64_t) + 1024;  // + alignment
static_assert(kBBytes % 1024 == 0 && kStageBytes % 1024 == 0,
              "128-byte swizzled tiles start on 1024-byte boundaries");
constexpr int kFullCount = 129;  // 128 loader threads' cp.async arrivals + TMA's expect
constexpr int kEmptyCount = 8;   // one arrival per consumer warp

// Float offset of element (m, k) of a stage's S tile [128 rows of the
// product x 32 of K].  Forward (A = S): row m's 32 floats are one 128-byte
// row, its 16-byte chunks XOR-swizzled by m % 8.  Backward (A = Sᵀ, so the
// tile holds S rows k, columns m): four [32 k x 32 m] blocks, row k's
// chunks swizzled by 2·(k % 4).  Either way a warp's fragment reads (rows
// g and g + 8, columns t and t + 4 of an 8-deep step; lane = 4·g + t) hit
// 32 distinct banks.
template <bool TRANS>
__device__ __forceinline__ int a_offset(int m, int k) {
  if (TRANS)
    return (m >> 5) * 1024 + k * 32 + ((((m & 31) >> 2) ^ ((k & 3) << 1)) << 2) + (m & 3);
  return m * 32 + (((k >> 2) ^ (m & 7)) << 2) + (k & 3);
}

// d = a · B, or d += a · B where `accumulate`, over one k8 step: m64n176k8,
// A (tf32) from registers, B from shared memory through `desc`.
__device__ __forceinline__ void wgmma_n176(float (&d)[88], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, {%88, %89, %90, %91}, %92, p, 1, 1;\n}\n"
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
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The loader's share of a stage's S tile: rows m0.. of the product, K k0..
// (forward: S[m0 + m, k0 + k]; backward: S[k0 + k, m0 + m]), zero past n.
// `vec`: n % 4 == 0 and S 16-byte aligned, so 16-byte chunks never straddle
// the edge; else 4-byte copies.
template <bool TRANS>
__device__ __forceinline__ void load_a(uint32_t dst, const float* __restrict__ s, int n,
                                       int m0, int k0, int t, bool vec) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // 1,024 chunks of 16 bytes, 8 a thread
      const int i = t + 128 * j;
      int m, k;
      if (TRANS) { k = i >> 5; m = 4 * (i & 31); }  // a warp reads 512 bytes of one S row
      else { m = i >> 3; k = 4 * (i & 7); }          // a warp reads 4 rows of 128 bytes
      const int gm = m0 + m, gk = k0 + k;
      const bool ok = gm < n && gk < n;
      const long long src = TRANS ? static_cast<long long>(gk) * n + gm
                                  : static_cast<long long>(gm) * n + gk;
      mma::cp_async_16(dst + 4 * a_offset<TRANS>(m, k), ok ? s + src : s, ok ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {  // 4,096 floats, 32 a thread
      const int i = t + 128 * j;
      int m, k;
      if (TRANS) { k = i >> 7; m = i & 127; }
      else { m = i >> 5; k = i & 31; }
      const int gm = m0 + m, gk = k0 + k;
      const bool ok = gm < n && gk < n;
      const long long src = TRANS ? static_cast<long long>(gk) * n + gm
                                  : static_cast<long long>(gm) * n + gk;
      mma::cp_async_4(dst + 4 * a_offset<TRANS>(m, k), ok ? s + src : s, ok ? 4 : 0);
    }
  }
}

// The A fragment of K step kk (columns 8·kk + t and + 4, rows r and r + 8 of
// the tile) from a stage's S tile, split into hi and lo TF32.
template <bool TRANS>
__device__ __forceinline__ void load_frag(const float* tile, int r, int t, int kk,
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int k = 8 * kk + t;
  mma::split_tf32(tile[a_offset<TRANS>(r, k)], hi[0], lo[0]);
  mma::split_tf32(tile[a_offset<TRANS>(r + 8, k)], hi[1], lo[1]);
  mma::split_tf32(tile[a_offset<TRANS>(r, k + 4)], hi[2], lo[2]);
  mma::split_tf32(tile[a_offset<TRANS>(r + 8, k + 4)], hi[3], lo[3]);
}

template <bool TRANS>
__global__ void __launch_bounds__(kThreads, 1)
hop_gemm_kernel(const __grid_constant__ CUtensorMap b_map, const float* __restrict__ s,
                float* __restrict__ out, int n, int cols, int col_tiles, int tiles, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = mma::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* smem = reinterpret_cast<const float*>(smem_raw + (base - raw));
  const uint32_t bars = base + kStages * kStageBytes;  // full[kStages], empty[kStages]
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mma::mbarrier_init(bars + 8 * st, kFullCount);
      mma::mbarrier_init(bars + 8 * (kStages + st), kEmptyCount);
    }
    mma::mbarrier_init_fence();
  }
  __syncthreads();
  const int kblocks = (n + kBK - 1) / kBK;

  if (tid < 128) {  // ---------------------------------------------- loader
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / col_tiles * kBM, n0 = tile % col_tiles * kBN;
      for (int kb = 0; kb < kblocks; ++kb) {
        const int k0 = kb * kBK;
        const uint32_t full = bars + 8 * stage, dst = base + stage * kStageBytes;
        mma::wait_parity(bars + 8 * (kStages + stage), phase ^ 1);  // consumers done with it
        load_a<TRANS>(dst, s, n, m0, k0, tid, vec != 0);
        mma::cp_async_arrive(full);
        if (tid == 0) {
          mma::mbarrier_expect(full, 2 * kBBytes);
          tma::load_3d(dst + kABytes, &b_map, k0, n0, 0, full);
          tma::load_3d(dst + kABytes + kBBytes, &b_map, k0, n0, 1, full);
        }
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // exit with no copy in flight
    return;
  }

  // --------------------------------------------------------------- consumers
  // Two accumulators of 88 floats a thread: the tensor cores' partial
  // sum of one stage (they add with truncation, so a sum over all of K
  // would drift by up to ~K/8 truncations of its own size) and the tile's
  // sum, kept in fp32 registers and added to once a stage, to nearest.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r = (tid - 128) / 128 * 64 + (tid / 32 % 4) * 16 + g;  // fragment rows r, r + 8
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / col_tiles * kBM, n0 = tile % col_tiles * kBN;
    float acc[kBN / 2], part[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = part[i] = 0.f;
    uint32_t ahi[2][4], alo[2][4];
    mma::wait_parity(bars + 8 * stage, phase);
    load_frag<TRANS>(smem + stage * (kStageBytes / 4), r, t, 0, ahi[0], alo[0]);
    for (int kb = 0; kb < kblocks; ++kb) {
      const uint64_t dhi = mma::desc_sw128(base + stage * kStageBytes + kABytes);
      const uint64_t dlo = dhi + (kBBytes >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma::wgmma_fence();
        wgmma_n176(part, alo[kk & 1], dhi + 2 * kk, kk > 0);  // the small terms first
        wgmma_n176(part, ahi[kk & 1], dlo + 2 * kk, 1);
        wgmma_n176(part, ahi[kk & 1], dhi + 2 * kk, 1);
        mma::wgmma_commit();
        if (kk < 3) {
          mma::wgmma_wait<1>();  // every product but these three is done
          load_frag<TRANS>(smem + stage * (kStageBytes / 4), r, t, kk + 1,
                           ahi[(kk + 1) & 1], alo[(kk + 1) & 1]);
        }
      }
      mma::wgmma_wait<0>();
      mma::fence_regs(part);
      if (lane == 0) mma::mbarrier_arrive(bars + 8 * (kStages + stage));  // the stage is free
      if (++stage == kStages) { stage = 0; phase ^= 1; }
      if (kb + 1 < kblocks) {
        mma::wait_parity(bars + 8 * stage, phase);
        load_frag<TRANS>(smem + stage * (kStageBytes / 4), r, t, 0, ahi[0], alo[0]);
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
      mma::fence_regs(part);
    }

    // Epilogue: d[4j + e] is row r + 8·(e / 2), column 8j + 2t + e % 2.
    const bool pairs = (cols & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gr = m0 + r + 8 * half;
      if (gr >= n) continue;
      float* row = out + static_cast<long long>(gr) * cols;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        if (pairs) {
          if (col < cols) *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        } else {
          if (col < cols) row[col] = v0;
          if (col + 1 < cols) row[col + 1] = v1;
        }
      }
    }
  }
}

// Z [k_len, bsz, c] in any strides (elements) to K-major TF32 planes:
// planes[p][b·c + c'][k] = (hi, lo)[p] of Z[k, b, c'], rows kp apart.  A
// 32 x 32 tile through shared memory, so that both sides are coalesced.
__global__ void __launch_bounds__(256)
hop_gemm_split_b(const float* __restrict__ z, float* __restrict__ planes, int k_len, int kp,
                 int c, int cols, long long sk, long long sb, long long sc) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, col = n0 + tx;
    float v = 0.f;
    if (k < k_len && col < cols) {
      const int b = col / c, cc = col - b * c;
      v = z[k * sk + b * sb + cc * sc];
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  const long long plane = static_cast<long long>(cols) * kp;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int col = n0 + i, k = k0 + tx;
    if (col < cols && k < k_len) {
      uint32_t hi, lo;
      mma::split_tf32(tile[tx][i], hi, lo);
      const long long o = static_cast<long long>(col) * kp + k;
      planes[o] = __uint_as_float(hi);
      planes[plane + o] = __uint_as_float(lo);
    }
  }
}

constexpr int kMaxDevices = 64;

template <bool TRANS>
cudaError_t launch(const CUtensorMap& map, const float* s, float* out, int n, int cols,
                   int sms, bool vec, cudaStream_t stream) {
  auto kernel = hop_gemm_kernel<TRANS>;
  // The shared-memory limit holds for the device's context: set it on the
  // first launch on each device, not on every one.
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  const int col_tiles = (cols + kBN - 1) / kBN, tiles = (n + kBM - 1) / kBM * col_tiles;
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, kThreads, kSmem, stream>>>(map, s, out, n, cols, col_tiles, tiles,
                                            vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// out = S @ Z (transpose = 0) or Sᵀ @ Z (transpose = 1).  s: [n, n]
// contiguous; z: [n, bsz, c] with element strides (sk, sb, sc); out: [n,
// bsz, c] contiguous; planes: scratch of 2 · bsz·c · kp floats, kp = n
// rounded up to 4, 16-byte aligned.  All fp32 on the current device,
// launched on `stream` over at most `sms` blocks.  Returns 0, a
// cudaError_t, or one of tma.cuh's kErr codes (see hop_gemm_error).
extern "C" int hop_gemm_f32(const float* s, const float* z, float* out, float* planes, int n,
                            int bsz, int c, long long sk, long long sb, long long sc,
                            int transpose, int sms, void* stream) {
  if (n <= 0 || bsz <= 0 || c <= 0) return 0;
  const long long cols_ll = static_cast<long long>(bsz) * c;
  if (cols_ll > (1 << 30) || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = static_cast<int>(cols_ll), kp = (n + 3) / 4 * 4;
  const auto st = static_cast<cudaStream_t>(stream);
  const tma::EncodeTiled encode = tma::encode_tiled();
  if (!encode) return tma::kErrNoEncoder;

  const dim3 split_grid((n + 31) / 32, (cols + 31) / 32);
  if (split_grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  hop_gemm_split_b<<<split_grid, dim3(32, 8), 0, st>>>(z, planes, n, kp, c, cols, sk, sb, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(cols), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kp) * 4,
                                 static_cast<cuuint64_t>(cols) * kp * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(kBN), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, planes, dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return tma::kErrTensorMap;

  const bool vec = n % 4 == 0 && reinterpret_cast<std::uintptr_t>(s) % 16 == 0;
  err = transpose ? launch<true>(map, s, out, n, cols, sms, vec, st)
                  : launch<false>(map, s, out, n, cols, sms, vec, st);
  return static_cast<int>(err);
}

extern "C" const char* hop_gemm_error(int code) {
  if (code == tma::kErrNoEncoder) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == tma::kErrTensorMap) return "cuTensorMapEncodeTiled refused the B planes' map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
