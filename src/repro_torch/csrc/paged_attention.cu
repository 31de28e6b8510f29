// Paged decode attention: one query token per sequence over K/V pages that
// the kernel finds through the sequence's page table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:
// paged_attention (body _paged_kernel). As there, the g query heads that
// share a K/V head share a block, every page is read straight from the pool
// (the pool is never gathered), a page that is unmapped (-1) or wholly
// outside [kv_len - window, kv_len) is skipped, and a key is visible when
// kpos < kv_len and (kv_len - 1) - kpos < window. A sequence with kv_len = 0
// sees nothing and gets 0. A page id past the pool reads the last page
// (JAX gathers clamp). Scores, softmax and sums are float32.
//
// The TPU walks the pages as a sequential grid axis. Here a block of 8
// warps owns one (sequence, K/V head, group of up to MAXG query heads); the
// warps take the pages in turn, each keeps its own online-softmax state in
// registers (lane j owns D / 32 dimensions of every head), and the block
// merges the 8 states in shared memory at the end, so one long sequence is
// read by 8 warps at once.
//
// Bound: bytes — every visible K and V row is read once per K/V head, and
// there are 4·D flops per query head and key against 4·D bytes (bf16) per
// K/V head and key. The design reads each K/V row once for all g heads of
// its group, with one coalesced D-element load per token and warp.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int WARPS = 8;

template <typename T, int D, int MAXG>
__global__ void __launch_bounds__(WARPS * 32) paged_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ kv_len, T* __restrict__ o, int hkv, int g,
    int n_pool, int ps, int n_pages, int use_window, int window,
    int use_softcap, float softcap, float scale) {
  constexpr int DPL = D / 32;
  constexpr int TK = MAXG * DPL >= 16 ? 4 : 8;   // tokens per step
  const int b = blockIdx.x, h = blockIdx.y;
  const int g0 = blockIdx.z * MAXG;
  const int ng = min(MAXG, g - g0);              // query heads of this block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hq = hkv * g, hq0 = h * g + g0;

  float qr[MAXG][DPL];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    if (gi < ng) {
      lm::load_vec<DPL>(q + ((int64_t)b * hq + hq0 + gi) * D + lane * DPL,
                        qr[gi]);
#pragma unroll
      for (int d = 0; d < DPL; ++d) qr[gi][d] *= scale;
    } else {
#pragma unroll
      for (int d = 0; d < DPL; ++d) qr[gi][d] = 0.f;
    }
  }

  const int kvl = kv_len[b];
  int pi_lo = 0;
  const int pi_hi = kvl > 0 ? min(n_pages, (kvl + ps - 1) / ps) : 0;
  if (use_window) pi_lo = max(0, kvl - window) / ps;

  float m[MAXG], l[MAXG], acc[MAXG][DPL];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    m[gi] = lm::NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[gi][d] = 0.f;
  }

  const int64_t tok_stride = (int64_t)hkv * D;
  for (int pi = pi_lo + warp; pi < pi_hi; pi += WARPS) {
    int pid = page_table[(int64_t)b * n_pages + pi];
    if (pid < 0) continue;
    pid = min(pid, n_pool - 1);
    const int64_t base = ((int64_t)pid * ps * hkv + h) * D + lane * DPL;
    const int first = pi * ps;
    for (int t0 = 0; t0 < ps; t0 += TK) {
      float kk[TK][DPL], vv[TK][DPL];
      bool vis[TK];
      bool any = false;
#pragma unroll
      for (int tt = 0; tt < TK; ++tt) {
        const int kpos = first + t0 + tt;
        vis[tt] = t0 + tt < ps && kpos < kvl &&
                  (!use_window || (kvl - 1) - kpos < window);
        any = any || vis[tt];
        if (t0 + tt < ps) {
          lm::load_vec<DPL>(kp + base + (t0 + tt) * tok_stride, kk[tt]);
          lm::load_vec<DPL>(vp + base + (t0 + tt) * tok_stride, vv[tt]);
        } else {
#pragma unroll
          for (int d = 0; d < DPL; ++d) kk[tt][d] = vv[tt][d] = 0.f;
        }
      }
      if (!any) continue;   // the same for every lane
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        if (gi >= ng) break;
        float s[TK];
        float mt = lm::NEG_INF;
#pragma unroll
        for (int tt = 0; tt < TK; ++tt) {
          float part = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) part = fmaf(qr[gi][d], kk[tt][d], part);
          s[tt] = lm::warp_sum(part);
          if (use_softcap) s[tt] = softcap * tanhf(s[tt] / softcap);
          if (vis[tt]) mt = fmaxf(mt, s[tt]);
        }
        const float m_new = fmaxf(m[gi], mt);
        const float corr = expf(m[gi] - m_new);
        l[gi] *= corr;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[gi][d] *= corr;
#pragma unroll
        for (int tt = 0; tt < TK; ++tt) {
          const float p = vis[tt] ? expf(s[tt] - m_new) : 0.f;
          l[gi] += p;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[gi][d] = fmaf(p, vv[tt][d], acc[gi][d]);
        }
        m[gi] = m_new;
      }
    }
  }

  // merge the warps' states
  extern __shared__ float smem[];
  float* s_m = smem;                    // [WARPS][MAXG]
  float* s_l = s_m + WARPS * MAXG;      // [WARPS][MAXG]
  float* s_acc = s_l + WARPS * MAXG;    // [WARPS][MAXG][D]
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    if (lane == 0) {
      s_m[warp * MAXG + gi] = m[gi];
      s_l[warp * MAXG + gi] = l[gi];
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      s_acc[(warp * MAXG + gi) * D + lane * DPL + d] = acc[gi][d];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += blockDim.x) {
    const int gi = i / D, c = i % D;
    float mx = lm::NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w * MAXG + gi]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(s_m[w * MAXG + gi] - mx);
      lt = fmaf(s_l[w * MAXG + gi], f, lt);
      at = fmaf(s_acc[(w * MAXG + gi) * D + c], f, at);
    }
    o[((int64_t)b * hq + hq0 + gi) * D + c] =
        lm::from_f<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D, int MAXG>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* kl, void* o, int nb, int hkv, int g, int n_pool,
           int ps, int n_pages, int use_window, int window, int use_softcap,
           float softcap, float scale, cudaStream_t s) {
  auto kern = paged_kernel<T, D, MAXG>;
  const int smem = WARPS * (2 * MAXG + MAXG * D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nb, (unsigned)hkv,
                  (unsigned)((g + MAXG - 1) / MAXG));
  kern<<<grid, WARPS * 32, smem, s>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)pt,
      (const int32_t*)kl, (T*)o, hkv, g, n_pool, ps, n_pages, use_window,
      window, use_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_group(int g, const void* q, const void* kp, const void* vp,
             const void* pt, const void* kl, void* o, int nb, int hkv,
             int n_pool, int ps, int n_pages, int use_window, int window,
             int use_softcap, float softcap, float scale, cudaStream_t s) {
#define PAGED_LAUNCH(G)                                                      \
  return launch<T, D, G>(q, kp, vp, pt, kl, o, nb, hkv, g, n_pool, ps,       \
                         n_pages, use_window, window, use_softcap, softcap, \
                         scale, s)
  if (g <= 1) PAGED_LAUNCH(1);
  if (g <= 2) PAGED_LAUNCH(2);
  if (g <= 4) PAGED_LAUNCH(4);
  PAGED_LAUNCH(8);   // larger groups take several blocks
#undef PAGED_LAUNCH
}

template <typename T>
int by_dim(int d, int g, const void* q, const void* kp, const void* vp,
           const void* pt, const void* kl, void* o, int nb, int hkv,
           int n_pool, int ps, int n_pages, int use_window, int window,
           int use_softcap, float softcap, float scale, cudaStream_t s) {
#define PAGED_DIM(D)                                                        \
  return by_group<T, D>(g, q, kp, vp, pt, kl, o, nb, hkv, n_pool, ps,      \
                        n_pages, use_window, window, use_softcap, softcap, \
                        scale, s)
  switch (d) {
    case 32: PAGED_DIM(32);
    case 64: PAGED_DIM(64);
    case 128: PAGED_DIM(128);
    case 256: PAGED_DIM(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_DIM
}

}  // namespace

// q [nb, hkv·g, d]; k/v pools [n_pool, ps, hkv, d]; page_table int32
// [nb, n_pages]; kv_len int32 [nb]; o [nb, hkv·g, d]. dtype 0 = float32,
// 1 = bfloat16.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_len, void* o, int dtype, int nb,
    int hkv, int g, int d, int n_pool, int ps, int n_pages, int use_window,
    int window, int use_softcap, float softcap, float scale, void* stream) {
  if (nb == 0 || hkv == 0 || g == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == lm::DTYPE_F32)
    return by_dim<float>(d, g, q, k_pool, v_pool, page_table, kv_len, o, nb,
                         hkv, n_pool, ps, n_pages, use_window, window,
                         use_softcap, softcap, scale, s);
  if (dtype == lm::DTYPE_BF16)
    return by_dim<__nv_bfloat16>(d, g, q, k_pool, v_pool, page_table, kv_len,
                                 o, nb, hkv, n_pool, ps, n_pages, use_window,
                                 window, use_softcap, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
