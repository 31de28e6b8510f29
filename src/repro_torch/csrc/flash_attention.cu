// Flash attention: online-softmax attention with GQA, a causal mask, a
// sliding window and a logit softcap, accumulated in float32.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_folded (body
// _flash_kernel). The TPU walks k-blocks as a sequential grid axis with the
// softmax state in VMEM scratch; here one block owns a tile of bq query
// rows of one head for its whole life, loops over the key range that tile
// can see (so causal and window structure cost nothing outside it) and
// keeps the state in registers.
//
// Layout: q [BHq, Sq, D], k/v [BHkv, Sk, D], float32 or bfloat16, out in
// q's dtype. Head bh reads K/V head bh / g. Scores are computed in float32
// from the scaled query (as the TPU kernel does); softcap comes before the
// mask. A masked key has weight exactly 0, so a row that sees no key at all
// ends with l = 0 and its output is 0 (the TPU kernel's output there
// depends on its block size; the reference's is an average of every key).
//
// Work split: each warp owns 8 query rows. Keys are staged bk at a time in
// shared memory (float32); within a stage, each group of 32 keys gives lane
// j key j for the scores (a float4 walk over D of its K row against the 8
// broadcast query rows), the row maxima and sums come from warp shuffles,
// the probabilities go through shared memory, and for P·V lane j owns
// D / 32 output dimensions of all 8 rows.
//
// Bound: at full width the products dominate (4·D flops per visible
// query-key pair against bytes of q, k, v and o read or written once), so
// the card's tensor-core rate is the bound; this kernel runs on the float32
// FMA units and shared memory instead — a first, simple port.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int ROWS = 8;   // query rows per warp
constexpr int KT = 32;    // keys per sub-tile: one per lane

template <typename T, int D>
__global__ void __launch_bounds__(512, 1) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int sq, int sk, int g,
    int causal, int use_window, int window, int use_softcap, float softcap,
    float scale, int bq, int bk) {
  constexpr int DPL = D / 32;   // output dimensions per lane
  constexpr int KS = D + 4;     // padded K row: conflict-free float4 reads
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);   // [bq][D], scaled
  float* s_k = s_q + bq * D;                       // [bk][KS]
  float* s_v = s_k + bk * KS;                      // [bk][D]
  float* s_p = s_v + bk * D;                       // [bq / ROWS][ROWS][KT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  // the longest tiles (last under a causal mask) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const T* qb = q + (int64_t)bh * sq * D;
  const T* kb = k + (int64_t)(bh / g) * sk * D;
  const T* vb = v + (int64_t)(bh / g) * sk * D;

  for (int i = threadIdx.x * 4; i < bq * D; i += blockDim.x * 4) {
    const int r = i / D, c = i % D;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) x = lm::load4(qb + (int64_t)(q0 + r) * D + c);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(s_q + i) = x;
  }

  // the keys any row of this tile can see
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, min(q0 + bq, sq));
  if (use_window) k_begin = max(0, q0 - window + 1);

  const int r0 = warp * ROWS;
  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = lm::NEG_INF;
    l[r] = 0.f;   // this lane's share of the row sum
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }
  float* p_w = s_p + warp * ROWS * KT;

  for (int kt = k_begin; kt < k_end; kt += bk) {
    const int nk = min(bk, k_end - kt);
    __syncthreads();   // the previous stage is consumed (and s_q written)
    for (int i = threadIdx.x * 4; i < bk * D; i += blockDim.x * 4) {
      const int r = i / D, c = i % D;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (r < nk) {
        kx = lm::load4(kb + (int64_t)(kt + r) * D + c);
        vx = lm::load4(vb + (int64_t)(kt + r) * D + c);
      }
      *reinterpret_cast<float4*>(s_k + r * KS + c) = kx;
      *reinterpret_cast<float4*>(s_v + r * D + c) = vx;
    }
    __syncthreads();

    for (int st = 0; st < nk; st += KT) {
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
      const float* krow = s_k + (st + lane) * KS;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 qq =
              *reinterpret_cast<const float4*>(s_q + (r0 + r) * D + c);
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
      }
      const int kpos = kt + st + lane;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int qpos = q0 + r0 + r;
        bool vis = st + lane < nk;
        if (causal) vis = vis && kpos <= qpos;
        if (use_window) vis = vis && qpos - kpos < window;
        float x = s[r];
        if (use_softcap) x = softcap * tanhf(x / softcap);
        float p = 0.f;
        if (__any_sync(0xFFFFFFFFu, vis)) {
          const float m_new = fmaxf(m[r], lm::warp_max(vis ? x : lm::NEG_INF));
          const float corr = expf(m[r] - m_new);
          if (vis) p = expf(x - m_new);
          l[r] = l[r] * corr + p;
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[r][j] *= corr;
          m[r] = m_new;
        }
        p_w[r * KT + lane] = p;
      }
      __syncwarp();
#pragma unroll 2
      for (int j = 0; j < KT; j += 4) {
        float4 pr[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          pr[r] = *reinterpret_cast<const float4*>(p_w + r * KT + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float vv[DPL];
          lm::load_row<DPL>(s_v + (st + j + jj) * D + lane * DPL, vv);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y
                             : jj == 2 ? pr[r].z : pr[r].w;
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(pj, vv[d], acc[r][d]);
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float lt = fmaxf(lm::warp_sum(l[r]), 1e-30f);
    const int qpos = q0 + r0 + r;
    if (qpos < sq) {
      T* orow = o + ((int64_t)bh * sq + qpos) * D + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) orow[d] = lm::from_f<T>(acc[r][d] / lt);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bhq,
           int sq, int sk, int g, int causal, int use_window, int window,
           int use_softcap, float softcap, float scale, int bq, int bk,
           int smem, cudaStream_t stream) {
  auto kern = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + bq - 1) / bq), (unsigned)bhq);
  kern<<<grid, (bq / ROWS) * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, g, causal,
      use_window, window, use_softcap, softcap, scale, bq, bk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int64_t bhq, int sq, int sk, int g, int causal, int use_window,
             int window, int use_softcap, float softcap, float scale, int bq,
             int bk, int smem, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, bhq, sq, sk, g, causal,
                                  use_window, window, use_softcap, softcap,
                                  scale, bq, bk, smem, s);
    case 64: return launch<T, 64>(q, k, v, o, bhq, sq, sk, g, causal,
                                  use_window, window, use_softcap, softcap,
                                  scale, bq, bk, smem, s);
    case 128: return launch<T, 128>(q, k, v, o, bhq, sq, sk, g, causal,
                                    use_window, window, use_softcap, softcap,
                                    scale, bq, bk, smem, s);
    case 256: return launch<T, 256>(q, k, v, o, bhq, sq, sk, g, causal,
                                    use_window, window, use_softcap, softcap,
                                    scale, bq, bk, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [bhq, sq, d], k/v [bhq / g, sk, d], o [bhq, sq, d]; dtype 0 = float32,
// 1 = bfloat16; bq a multiple of 8 up to 128, bk a multiple of 32; smem the
// dynamic shared memory those sizes need (the wrapper computes it).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int64_t bhq, int sq, int sk, int d, int g, int causal, int use_window,
    int window, int use_softcap, float softcap, float scale, int bq, int bk,
    int smem, void* stream) {
  if (bhq == 0 || sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == lm::DTYPE_F32)
    return dispatch<float>(d, q, k, v, o, bhq, sq, sk, g, causal, use_window,
                           window, use_softcap, softcap, scale, bq, bk, smem,
                           s);
  if (dtype == lm::DTYPE_BF16)
    return dispatch<__nv_bfloat16>(d, q, k, v, o, bhq, sq, sk, g, causal,
                                   use_window, window, use_softcap, softcap,
                                   scale, bq, bk, smem, s);
  return (int)cudaErrorInvalidValue;
}
