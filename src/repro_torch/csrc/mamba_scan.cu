// Selective scan (Mamba SSM): per channel d and state n,
//   a = exp(dt · -exp(A_log[d, n])),  b = dt · x · B[n],
//   h ← a ⊙ h + b,                    y = Σ_n h · C[n] + D_skip[d] · x,
// with h starting at zero and carried across the whole sequence.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py:mamba_scan
// (body _scan_kernel). As there, a and b never reach device memory. The TPU
// steps through chunks as a sequential grid axis with h in VMEM scratch;
// here one thread owns one (batch, channel) with its N states in registers
// and walks the sequence itself. Each block stages a chunk of steps — dt
// and x of its channels, B and C of its batch row — in shared memory, so
// the loads of a chunk are issued together and the sequential part reads
// shared memory only. Everything is float32 (expf), as in the TPU kernel.
//
// Bound: the exponentials — B·S·Di·N of them on the SFU (16 a clock per SM
// on compute capability 9.0) — above the bytes of dt, x, B, C and y read
// or written once. The design gives only B·Di threads, one per sequential
// chain, so at B·Di ≈ 16k the card holds about 4 warps per SM.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

template <typename T, int MAXN>
__global__ void scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                            const T* __restrict__ Bm, const T* __restrict__ Cm,
                            const float* __restrict__ A_log,
                            const float* __restrict__ D_skip,
                            T* __restrict__ y, int S, int Di, int N,
                            int chunk) {
  extern __shared__ float smem[];
  const int bd = blockDim.x;
  float* s_b = smem;                  // [chunk][N]
  float* s_c = s_b + chunk * N;       // [chunk][N]
  float* s_dt = s_c + chunk * N;      // [chunk][bd]
  float* s_x = s_dt + chunk * bd;     // [chunk][bd]

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * bd;
  const int d = d0 + threadIdx.x;
  const bool live = d < Di;

  float A[MAXN], h[MAXN];
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    A[n] = live && n < N ? -expf(A_log[(int64_t)d * N + n]) : 0.f;
    h[n] = 0.f;
  }
  const float dskip = live ? D_skip[d] : 0.f;

  const int64_t row0 = (int64_t)b * S;
  for (int t0 = 0; t0 < S; t0 += chunk) {
    const int nt = min(chunk, S - t0);
    __syncthreads();   // the previous chunk is consumed
    for (int i = threadIdx.x; i < nt * N; i += bd) {
      s_b[i] = lm::to_f(Bm[(row0 + t0) * N + i]);
      s_c[i] = lm::to_f(Cm[(row0 + t0) * N + i]);
    }
    for (int i = threadIdx.x; i < nt * bd; i += bd) {
      const int tt = i / bd, dd = d0 + i % bd;
      const int64_t at = (row0 + t0 + tt) * Di + dd;
      s_dt[i] = dd < Di ? lm::to_f(dt[at]) : 0.f;
      s_x[i] = dd < Di ? lm::to_f(x[at]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = s_dt[tt * bd + threadIdx.x];
      const float xv = s_x[tt * bd + threadIdx.x];
      const float dx = dtv * xv;
      const float* bt = s_b + tt * N;
      const float* ct = s_c + tt * N;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < MAXN; ++n) {
        if (n < N) {
          h[n] = fmaf(expf(dtv * A[n]), h[n], dx * bt[n]);
          acc = fmaf(h[n], ct[n], acc);
        }
      }
      y[(row0 + t0 + tt) * Di + d] = lm::from_f<T>(fmaf(dskip, xv, acc));
    }
  }
}

template <typename T, int MAXN>
int launch(const void* dt, const void* x, const void* Bm, const void* Cm,
           const void* A_log, const void* D_skip, void* y, int B, int S,
           int Di, int N, int bd, int chunk, cudaStream_t s) {
  auto kern = scan_kernel<T, MAXN>;
  const int smem = 2 * chunk * (N + bd) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Di + bd - 1) / bd), (unsigned)B);
  kern<<<grid, bd, smem, s>>>((const T*)dt, (const T*)x, (const T*)Bm,
                              (const T*)Cm, (const float*)A_log,
                              (const float*)D_skip, (T*)y, S, Di, N, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int by_state(const void* dt, const void* x, const void* Bm, const void* Cm,
             const void* A_log, const void* D_skip, void* y, int B, int S,
             int Di, int N, int bd, int chunk, cudaStream_t s) {
#define SCAN_LAUNCH(MAXN)                                                  \
  return launch<T, MAXN>(dt, x, Bm, Cm, A_log, D_skip, y, B, S, Di, N, bd, \
                         chunk, s)
  if (N <= 8) SCAN_LAUNCH(8);
  if (N <= 16) SCAN_LAUNCH(16);
  if (N <= 32) SCAN_LAUNCH(32);
  if (N <= 64) SCAN_LAUNCH(64);
#undef SCAN_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dt, x [B, S, Di]; Bm, Cm [B, S, N] in one dtype (0 = float32,
// 1 = bfloat16); A_log float32 [Di, N]; D_skip float32 [Di]; y [B, S, Di] in
// that dtype. bd channels per block; chunk steps staged at a time.
extern "C" int mamba_scan_launch(const void* dt, const void* x, const void* Bm,
                                 const void* Cm, const void* A_log,
                                 const void* D_skip, void* y, int dtype, int B,
                                 int S, int Di, int N, int bd, int chunk,
                                 void* stream) {
  if (B == 0 || S == 0 || Di == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == lm::DTYPE_F32)
    return by_state<float>(dt, x, Bm, Cm, A_log, D_skip, y, B, S, Di, N, bd,
                           chunk, s);
  if (dtype == lm::DTYPE_BF16)
    return by_state<__nv_bfloat16>(dt, x, Bm, Cm, A_log, D_skip, y, B, S, Di,
                                   N, bd, chunk, s);
  return (int)cudaErrorInvalidValue;
}
