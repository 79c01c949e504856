// The Tensor Memory Accelerator as hop_gemm.cu and hop_project.cu use it
// (sm_90): tiled loads of 2-D and 3-D tensors into shared memory, counted on
// an mbarrier, and the driver's encoder of their tensor maps, reached
// through the runtime so that no library links to libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tma {

// A [box] tile of the 2-D tensor `map` at coordinates (c0, c1), innermost
// first, to shared memory at `dst`; its bytes are counted on `bar`.
__device__ __forceinline__ void load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// As load_2d, of a 3-D tensor at (c0, c1, c2).
__device__ __forceinline__ void load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime, or null.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Launch errors of the kernels' C entries that are not CUDA's own (CUDA's
// run below 1,000).
constexpr int kErrNoEncoder = 10001;
constexpr int kErrTensorMap = 10002;

}  // namespace tma
