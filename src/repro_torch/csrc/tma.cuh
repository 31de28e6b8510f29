// Tensor Memory Accelerator loads and mbarriers for the tensor-core routes
// (flash_attention.cu, moe_gmm.cu): a producer thread asks TMA for a tile,
// the hardware writes it into shared memory with the 128- or 64-byte
// swizzle wgmma reads and counts its bytes on an mbarrier, and consumers
// wait on that barrier's phase.
//
// Host side: tensor maps of 3-D bf16 arrays, encoded by libcuda's
// cuTensorMapEncodeTiled, found at run time with cudaGetDriverEntryPoint
// (no link against libcuda). Elements outside the array come back as 0.
#pragma once
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace tma {

// ---- device ---------------------------------------------------------------
__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}
// make initialised barriers visible to every thread and to TMA (then
// __syncthreads)
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA writes to come
__device__ __forceinline__ void arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed (a fresh
// barrier counts the phase before its first as complete, so a wait on
// parity 1 passes at once). A wait that outlasts any tile's work by far
// traps, so that a fault surfaces as a launch error and not as a hang.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// the box at (c0, c1, c2) of `map` into dst, its bytes counted on bar
__device__ __forceinline__ void load(void* dst, const CUtensorMap* map,
                                     int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem(bar))
      : "memory");
}

// ---- host -----------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of the bf16 array [d2][d1][d0] (d0 contiguous, d0 a multiple of 8)
// whose box is [1][b1][b0] with b0 · 2 bytes = the swizzle width (128 or
// 64). Returns a CUDA error code (0 on success).
inline int map3d(CUtensorMap* map, const void* base, uint64_t d0,
                 uint64_t d1, uint64_t d2, uint32_t b0, uint32_t b1) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      b0 * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace tma
