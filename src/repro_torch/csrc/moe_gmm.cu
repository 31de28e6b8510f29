// Grouped expert FFN: per expert e, out[e] = (act(x[e] @ w_gate[e]) *
// (x[e] @ w_in[e])) @ w_out[e], with act = silu or gelu (tanh approximation,
// JAX's default), or sq_relu, which ignores the gate: relu(x @ w_in)^2 @
// w_out. Products and the activation are float32; the output is cast to
// x's dtype at the end.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py:moe_gmm (body
// _gmm_kernel). The TPU fuses the three products over blocks of F with the
// output accumulated in VMEM. Here the intermediate a·h goes through global
// memory in float32 between two launches on one stream:
//   1. gate/up: a·h [E, C, F] = act(x @ w_gate) * (x @ w_in), both products
//      from one staged tile of x;
//   2. down: out [E, C, D] = a·h @ w_out.
// Both are one tiled float32 GEMM (64 × 64 output tile per block of 256
// threads, 4 × 4 outputs per thread, K staged 16 at a time in shared
// memory), batched over experts by blockIdx.z. Ragged edges are masked, so
// no F column is padded; a zero-padded column of the caller's would add
// act(0)·0 = 0 exactly.
//
// Bound: operations — 2·E·C·D·F flops per product (three products, two for
// sq_relu) against one read of x and the weights. The card's rate for that
// is its bf16 tensor cores; this kernel runs on the float32 FMA units — a
// first, simple port.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;

enum Mode { SILU = 0, GELU = 1, SQ_RELU = 2, DOWN = 3 };

__device__ __forceinline__ float silu(float g) {
  return g * (1.f / (1.f + expf(-g)));
}
__device__ __forceinline__ float gelu_tanh(float g) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
}

// C[e] = A[e] (M × K) @ B0[e] (K × N), and with two products also
// A[e] @ B1[e]; both row-major. The epilogue of `mode` writes float (the
// gate/up stage) or T (the down stage) to out[e] (M × N).
template <typename TA, typename TB, int MODE>
__global__ void __launch_bounds__(THREADS) gmm_kernel(
    const TA* __restrict__ A, const TB* __restrict__ B0,
    const TB* __restrict__ B1, void* __restrict__ out, int M, int N, int K) {
  constexpr bool DUAL = MODE == SILU || MODE == GELU;
  __shared__ float4 a_s4[BK * BM / 4];     // A tile, transposed: [BK][BM]
  __shared__ float4 b0_s4[BK * BN / 4];    // [BK][BN]
  __shared__ float4 b1_s4[DUAL ? BK * BN / 4 : 1];
  float* a_s = reinterpret_cast<float*>(a_s4);
  float* b0_s = reinterpret_cast<float*>(b0_s4);
  float* b1_s = reinterpret_cast<float*>(b1_s4);

  const int e = blockIdx.z;
  const TA* Ae = A + (int64_t)e * M * K;
  const TB* B0e = B0 + (int64_t)e * K * N;
  const TB* B1e = DUAL ? B1 + (int64_t)e * K * N : nullptr;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // consecutive blocks share a column tile of B, so each weight tile
  // comes from device memory about once and the rows of A from L2
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc0[TM][TN], acc1[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc0[i][j] = acc1[i][j] = 0.f;

  // staging: thread t loads A row t / 4, k (t % 4)·4 .. +3, and B row
  // t / 16, n (t % 16)·4 .. +3
  const int ar = tid >> 2, ac = (tid & 3) * 4;
  const int br = tid >> 4, bc = (tid & 15) * 4;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ar, gk = k0 + ac + i;
      a_s[(ac + i) * BM + ar] =
          gm < M && gk < K ? lm::to_f(Ae[(int64_t)gm * K + gk]) : 0.f;
      const int gk2 = k0 + br, gn = n0 + bc + i;
      const bool inb = gk2 < K && gn < N;
      b0_s[br * BN + bc + i] =
          inb ? lm::to_f(B0e[(int64_t)gk2 * N + gn]) : 0.f;
      if constexpr (DUAL)
        b1_s[br * BN + bc + i] =
            inb ? lm::to_f(B1e[(int64_t)gk2 * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = a_s4[(kk * BM + ty * TM) / 4];
      const float4 b = b0_s4[(kk * BN + tx * TN) / 4];
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc0[i][j] = fmaf(av[i], bv[j], acc0[i][j]);
      if constexpr (DUAL) {
        const float4 c = b1_s4[(kk * BN + tx * TN) / 4];
        const float cv[TN] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc1[i][j] = fmaf(av[i], cv[j], acc1[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      const int64_t at = ((int64_t)e * M + gm) * N + gn;
      if constexpr (MODE == DOWN) {
        reinterpret_cast<TB*>(out)[at] = lm::from_f<TB>(acc0[i][j]);
      } else if constexpr (MODE == SQ_RELU) {
        const float r = fmaxf(acc0[i][j], 0.f);
        reinterpret_cast<float*>(out)[at] = r * r;
      } else if constexpr (MODE == SILU) {
        reinterpret_cast<float*>(out)[at] = silu(acc0[i][j]) * acc1[i][j];
      } else {
        reinterpret_cast<float*>(out)[at] = gelu_tanh(acc0[i][j]) * acc1[i][j];
      }
    }
  }
}

template <typename TA, typename TB, int MODE>
int gemm(const TA* A, const TB* B0, const TB* B1, void* out, int E, int M,
         int N, int K, cudaStream_t s) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)E);
  gmm_kernel<TA, TB, MODE><<<grid, THREADS, 0, s>>>(A, B0, B1, out, M, N, K);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* wg, const void* wi, const void* wo,
        float* ah, void* out, int E, int C, int D, int F, int act,
        cudaStream_t s) {
  const T* xt = (const T*)x;
  int err;
  if (act == SILU)
    err = gemm<T, T, SILU>(xt, (const T*)wg, (const T*)wi, ah, E, C, F, D, s);
  else if (act == GELU)
    err = gemm<T, T, GELU>(xt, (const T*)wg, (const T*)wi, ah, E, C, F, D, s);
  else if (act == SQ_RELU)
    err = gemm<T, T, SQ_RELU>(xt, (const T*)wi, (const T*)nullptr, ah, E, C,
                              F, D, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  return gemm<float, T, DOWN>(ah, (const T*)wo, (const T*)nullptr, out, E,
                              C, D, F, s);
}

}  // namespace

// x [E, C, D]; w_gate, w_in [E, D, F]; w_out [E, F, D]; ah float32
// [E, C, F] scratch; out [E, C, D] in x's dtype. dtype 0 = float32,
// 1 = bfloat16; act 0 = silu, 1 = gelu (tanh), 2 = sq_relu.
extern "C" int moe_gmm_launch(const void* x, const void* w_gate,
                              const void* w_in, const void* w_out, void* ah,
                              void* out, int dtype, int E, int C, int D,
                              int F, int act, void* stream) {
  if (E == 0 || C == 0 || D == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == lm::DTYPE_F32)
    return run<float>(x, w_gate, w_in, w_out, (float*)ah, out, E, C, D, F,
                      act, s);
  if (dtype == lm::DTYPE_BF16)
    return run<__nv_bfloat16>(x, w_gate, w_in, w_out, (float*)ah, out, E, C,
                              D, F, act, s);
  return (int)cudaErrorInvalidValue;
}
