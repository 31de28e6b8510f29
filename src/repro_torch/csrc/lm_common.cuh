// Device helpers shared by the LM kernels (flash_attention.cu,
// paged_attention.cu, moe_gmm.cu, mamba_scan.cu): float32 and bfloat16
// loads widened to float, stores narrowed with round-to-nearest-even (as
// PyTorch's .to(torch.bfloat16)), warp reductions, and 16-byte cp.async
// copies into shared memory.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lm {

constexpr float NEG_INF = -1e30f;   // the reference's mask value
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements as a float4. The address must be aligned to
// four elements (16 bytes for float, 8 for bfloat16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bfloat16 is the high half of the float32 it widens to
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}

// 16 bytes of global memory into shared memory without passing through
// registers; with src_bytes = 0 nothing is read and the 16 bytes are zeroed.
// Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

// DPL contiguous floats of shared memory, loaded 4, 2 or 1 at a time.
template <int DPL>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (DPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = p[i];
  }
}

// DPL contiguous bfloat16 or float32 elements of shared memory widened to
// float (aligned to DPL elements, at most 16 bytes).
template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  if constexpr (DPL % 8 == 0) {
#pragma unroll
    for (int i = 0; i < DPL; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[i + 2 * j] = __uint_as_float(w[j] << 16);
        out[i + 2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
      }
    }
  } else if constexpr (DPL == 4) {
    const float4 v = load4(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (DPL == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    out[0] = __uint_as_float(u << 16);
    out[1] = __uint_as_float(u & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = to_f(p[i]);
  }
}

// DPL contiguous elements of global memory widened to float (aligned to
// four elements when DPL is a multiple of 4).
template <int DPL, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const float4 v = load4(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[i] = to_f(p[i]);
  }
}

}  // namespace lm
