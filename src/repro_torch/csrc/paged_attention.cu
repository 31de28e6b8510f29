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
// Bound: bytes. Every visible K and V row is read once per K/V head, and
// there are 4·D flops per query head and key against 4·D bytes (bf16) per
// K/V head and key: at gemma2-27b decode (g = 2) 2 flops a byte, far below
// the FP32 units' 20 a byte, so the products stay on the FMA units in
// float32 (no tensor-core rounding of P).
//
// The TPU walks the pages as a sequential grid axis. Here the work is cut
// along the sequence: launch 1 is one block per (sequence, partition of
// `part` pages, K/V head, group of up to MAXG query heads), the grid sized
// from the table's width alone (the host reads no kv_len). A block whose
// partition holds no visible token exits at once, so the longest sequence
// is spread over as many blocks as it has partitions and sets the time no
// more than any other. Each block's warps take the partition's 16-key
// tiles in turn, each warp through its own ring of NST = 3 stages in shared
// memory, fed by 16-byte cp.async copies (a lane per copy, rows of
// unmapped pages zero-filled) two tiles ahead of the tile it computes: the
// page ids of the partition are staged first, so no copy waits on a table
// read. A block has as many warps as fit 56 KB of rings (two at D = 128 in
// bf16, four blocks an SM): on the H100, more warps with fewer tiles in
// flight each beat deeper rings. Within a tile two lanes own a key, half
// the dimensions each: they take that key's scores with the g query heads
// (q scaled once, in shared memory), add them with one shuffle, and pay
// the softcap's tanh and the exp once per score; one warp max per tile and
// head moves the softmax state. For P·V the lanes own D / 32 dimensions
// and read the probabilities back from shared memory. The warps' states
// merge in shared memory into one partial (m, l, acc[g, D]) per block,
// written to a float32 scratch; launch 2 merges each (sequence, query
// head)'s partials in the same math and writes o. With one partition a
// sequence, launch 1 writes o itself and launch 2 is skipped.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int PAD = 16;   // bytes after each K/V row in shared memory

// Tile geometry for element type T and head dim D (ops.py mirrors it): a
// tile is TK = 16 keys, two lanes a key for the scores.
template <typename T, int D>
struct Ring {
  static constexpr int TK = 16;
  static constexpr int ROW = D * (int)sizeof(T);   // bytes of a K or V row
  static constexpr int RS = ROW + PAD;              // padded: lanes reading
                                                    // their own rows spread
                                                    // over the banks
  static constexpr int CH = ROW / 16;               // 16-byte copies a row
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a copy
  static constexpr int STAGE = 2 * TK * RS;         // a tile of K and of V
  static constexpr int NST = 3;
  static constexpr int NW_FIT = 56 * 1024 / (NST * STAGE);
  static constexpr int NW = NW_FIT < 1 ? 1 : (NW_FIT > 4 ? 4 : NW_FIT);
};

// Tokens [lo, hi) of a sequence that can be visible, clipped to the table.
__device__ __forceinline__ void visible_tokens(int kvl, int use_window,
                                               int window, int ps,
                                               int n_pages, int64_t& lo,
                                               int64_t& hi) {
  hi = min((int64_t)kvl, (int64_t)n_pages * ps);
  lo = use_window ? max((int64_t)0, (int64_t)kvl - window) : 0;
}

template <typename T, int D, int MAXG>
__global__ void __launch_bounds__(Ring<T, D>::NW * 32) paged_part_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ kv_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, T* __restrict__ o, int hkv, int g,
    int n_groups, int n_pool, int ps, int n_pages, int part, int n_part,
    int use_window, int window, int use_softcap, float softcap,
    float scale) {
  using R = Ring<T, D>;
  constexpr int NW = R::NW, NST = R::NST, TK = R::TK, DPL = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                // [NW][NST]
  float* q_s = reinterpret_cast<float*>(smem + NW * NST * R::STAGE);
  float* p_s = q_s + MAXG * D;                               // [NW][TK][MAXG]
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(p_s + NW * TK * MAXG);
  int* pid_s = reinterpret_cast<int*>(mask_s + NW * NST);    // [part]

  const int n_hg = hkv * n_groups;
  const int hg = (int)(blockIdx.x % n_hg);
  const int64_t bp = blockIdx.x / n_hg;
  const int p = (int)(bp % n_part), b = (int)(bp / n_part);
  const int h = hg / n_groups, g0 = (hg % n_groups) * MAXG;
  const int ng = min(MAXG, g - g0);
  const int hq = hkv * g, hq0 = h * g + g0;
  const bool direct = n_part == 1;   // this block writes o itself

  int64_t lo, hi;
  visible_tokens(kv_len[b], use_window, window, ps, n_pages, lo, hi);
  const int64_t p0 = (int64_t)p * part * ps;
  lo = max(lo, p0);
  hi = min(hi, p0 + (int64_t)part * ps);
  if (lo >= hi) {   // nothing of this partition is visible
    if (direct)
      for (int i = threadIdx.x; i < ng * D; i += NW * 32)
        o[((int64_t)b * hq + hq0) * D + i] = lm::from_f<T>(0.f);
    return;
  }

  for (int i = threadIdx.x; i < MAXG * D; i += NW * 32) {
    const int gi = i / D;
    q_s[i] = gi < ng
        ? lm::to_f(q[((int64_t)b * hq + hq0 + gi) * D + i % D]) * scale
        : 0.f;
  }
  const int pg0 = p * part;
  for (int i = threadIdx.x; i < min(part, n_pages - pg0); i += NW * 32) {
    const int pid = page_table[(int64_t)b * n_pages + pg0 + i];
    pid_s[i] = pid < 0 ? -1 : min(pid, n_pool - 1);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = lane % TK, half = lane / TK;   // this lane's key, half
  const int tok0 = (int)lo, n_tok = (int)(hi - lo);
  const int n_tiles = (n_tok + TK - 1) / TK;
  const int n_mine = warp < n_tiles ? (n_tiles - warp + NW - 1) / NW : 0;
  const int64_t row_stride = (int64_t)hkv * D;   // elements between tokens
  unsigned char* my_ring = ring + warp * NST * R::STAGE;
  float* my_p = p_s + warp * TK * MAXG;
  uint32_t* my_mask = mask_s + warp * NST;

  // Copy this warp's i-th tile into stage s: lane r finds the pool row of
  // the tile's key r % TK, the warp shares them, and each lane copies every
  // 32nd 16-byte piece of the TK K rows and the TK V rows.
  auto issue = [&](int i, int s) {
    const int tok = tok0 + (warp + i * NW) * TK + key;
    int row = -1;
    if (tok < tok0 + n_tok) {
      const int pi = tok / ps;
      const int pid = pid_s[pi - pg0];
      if (pid >= 0) row = pid * ps + (tok - pi * ps);
    }
    const uint32_t mask = __ballot_sync(0xFFFFFFFFu, row >= 0) & 0xFFFFu;
    if (lane == 0) my_mask[s] = mask;
    if (mask) {
      unsigned char* kd = my_ring + s * R::STAGE;
      unsigned char* vd = kd + TK * R::RS;
#pragma unroll 4
      for (int c = lane; c < TK * R::CH; c += 32) {
        const int r = c / R::CH, piece = c % R::CH;
        const int rr = __shfl_sync(0xFFFFFFFFu, row, r);
        const int64_t off =
            (int64_t)max(rr, 0) * row_stride + (int64_t)h * D +
            piece * R::EPC;
        const int n = rr >= 0 ? 16 : 0;
        lm::cp_async16(kd + r * R::RS + piece * 16, kp + off, n);
        lm::cp_async16(vd + r * R::RS + piece * 16, vp + off, n);
      }
    }
    lm::cp_async_commit();
  };

  float m[MAXG], l[MAXG], acc[MAXG][DPL];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    m[gi] = lm::NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[gi][d] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_mine) issue(i, i);
    else lm::cp_async_commit();
  }
  for (int i = 0; i < n_mine; ++i) {
    const int ahead = i + NST - 1;
    if (ahead < n_mine) issue(ahead, ahead % NST);
    else lm::cp_async_commit();
    lm::cp_async_wait<NST - 1>();   // tile i's copies, this lane's
    __syncwarp();                    // ... and every lane's
    const int s = i % NST;
    const uint32_t mask = my_mask[s];
    if (mask) {
      const unsigned char* kd = my_ring + s * R::STAGE;
      const unsigned char* vd = kd + TK * R::RS;
      const bool vis = (mask >> key) & 1u;
      // scores of this lane's key with the group's query heads, over its
      // half of the dimensions (the key's two lanes then add up)
      const T* krow = reinterpret_cast<const T*>(kd + key * R::RS);
      float sc[MAXG];
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) sc[gi] = 0.f;
#pragma unroll 4
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); c += R::EPC) {
        float kk[R::EPC];
        lm::load_row<R::EPC>(krow + c, kk);
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi) {
          if (gi < ng) {
            float qq[R::EPC];
            lm::load_row<R::EPC>(q_s + gi * D + c, qq);
#pragma unroll
            for (int e = 0; e < R::EPC; ++e)
              sc[gi] = fmaf(qq[e], kk[e], sc[gi]);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        if (gi < ng) {
          float sv = sc[gi];
          sv += __shfl_xor_sync(0xFFFFFFFFu, sv, 16);
          if (use_softcap) sv = softcap * tanhf(sv / softcap);
          sv = vis ? sv : lm::NEG_INF;
          const float m_new = fmaxf(m[gi], lm::warp_max(sv));
          const float corr = expf(m[gi] - m_new);
          const float pr = vis ? expf(sv - m_new) : 0.f;
          l[gi] = fmaf(l[gi], corr, half ? 0.f : pr);   // this lane's keys
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[gi][d] *= corr;
          m[gi] = m_new;
          if (half == 0) my_p[key * MAXG + gi] = pr;
        }
      }
      __syncwarp();
      // P·V: this lane's D / 32 dimensions over the tile's keys (the rows
      // of invisible keys are zero and weigh 0)
#pragma unroll 4
      for (int k = 0; k < TK; ++k) {
        float vv[DPL], pk[MAXG];
        lm::load_row<DPL>(
            reinterpret_cast<const T*>(vd + k * R::RS) + lane * DPL, vv);
        lm::load_row<MAXG>(my_p + k * MAXG, pk);
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi) {
          if (gi < ng) {
#pragma unroll
            for (int d = 0; d < DPL; ++d)
              acc[gi][d] = fmaf(pk[gi], vv[d], acc[gi][d]);
          }
        }
      }
    }
    __syncwarp();   // stage s is free for the tile NST - 1 ahead
  }

  // merge the warps' states in shared memory (the rings are done)
  __syncthreads();
  float* mg = reinterpret_cast<float*>(ring);   // [NW][MAXG][D + 2]
  static_assert(NW * MAXG * (D + 2) * 4 <= NW * NST * R::STAGE,
                "the merge area must fit in the rings");
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    if (gi < ng) {
      float* w = mg + (warp * MAXG + gi) * (D + 2);
      const float lw = lm::warp_sum(l[gi]);
      if (lane == 0) {
        w[D] = m[gi];
        w[D + 1] = lw;
      }
#pragma unroll
      for (int d = 0; d < DPL; ++d) w[lane * DPL + d] = acc[gi][d];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += NW * 32) {
    const int gi = i / D, c = i % D;
    float mx = lm::NEG_INF;
    for (int w = 0; w < NW; ++w)
      mx = fmaxf(mx, mg[(w * MAXG + gi) * (D + 2) + D]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float* ws = mg + (w * MAXG + gi) * (D + 2);
      const float f = expf(ws[D] - mx);
      lt = fmaf(ws[D + 1], f, lt);
      at = fmaf(ws[c], f, at);
    }
    const int64_t bh = (int64_t)b * hq + hq0 + gi;
    if (direct) {
      o[bh * D + c] = lm::from_f<T>(at / fmaxf(lt, 1e-30f));
    } else {
      part_acc[(bh * n_part + p) * D + c] = at;
      if (c == 0) {
        part_ml[(bh * n_part + p) * 2] = mx;
        part_ml[(bh * n_part + p) * 2 + 1] = lt;
      }
    }
  }
}

// Launch 2: o[b, head] from the partials of the partitions of sequence b
// that launch 1 computed (the same visible range decides which).
template <typename T>
__global__ void paged_merge_kernel(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml,
                                   const int32_t* __restrict__ kv_len,
                                   T* __restrict__ o, int hq, int D, int ps,
                                   int n_pages, int part, int n_part,
                                   int use_window, int window) {
  const int64_t bh = blockIdx.x;
  int64_t lo, hi;
  visible_tokens(kv_len[bh / hq], use_window, window, ps, n_pages, lo, hi);
  const int64_t span = (int64_t)part * ps;
  const int p_lo = lo < hi ? (int)(lo / span) : 0;
  const int p_hi = lo < hi ? (int)((hi + span - 1) / span) : 0;
  const float* ml = part_ml + bh * n_part * 2;
  float mx = lm::NEG_INF;
  for (int p = p_lo; p < p_hi; ++p) mx = fmaxf(mx, ml[2 * p]);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float lt = 0.f, at = 0.f;
    for (int p = p_lo; p < p_hi; ++p) {
      const float f = expf(ml[2 * p] - mx);
      lt = fmaf(ml[2 * p + 1], f, lt);
      at = fmaf(part_acc[(bh * n_part + p) * D + c], f, at);
    }
    o[bh * D + c] = lm::from_f<T>(at / fmaxf(lt, 1e-30f));
  }
}

struct Args {
  const void *q, *kp, *vp, *pt, *kl;
  void *o, *scratch;
  int nb, hkv, g, d, n_pool, ps, n_pages, part, use_window, window,
      use_softcap;
  float softcap, scale;
};

template <typename T, int D, int MAXG>
int launch(const Args& a, cudaStream_t s) {
  using R = Ring<T, D>;
  auto kern = paged_part_kernel<T, D, MAXG>;
  const int smem = R::NW * R::NST * R::STAGE +
                   4 * (MAXG * D + R::NW * R::TK * MAXG + R::NW * R::NST) +
                   4 * a.part;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (a.g + MAXG - 1) / MAXG;
  const int n_part = max(1, (a.n_pages + a.part - 1) / a.part);
  const int hq = a.hkv * a.g;
  float* acc = static_cast<float*>(a.scratch);
  float* ml = acc + (int64_t)a.nb * hq * n_part * D;
  const unsigned grid = (unsigned)((int64_t)a.nb * n_part * a.hkv * n_groups);
  kern<<<grid, R::NW * 32, smem, s>>>(
      (const T*)a.q, (const T*)a.kp, (const T*)a.vp, (const int32_t*)a.pt,
      (const int32_t*)a.kl, acc, ml, (T*)a.o, a.hkv, a.g, n_groups,
      a.n_pool, a.ps, a.n_pages, a.part, n_part, a.use_window, a.window,
      a.use_softcap, a.softcap, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_part == 1) return (int)err;
  paged_merge_kernel<T><<<(unsigned)((int64_t)a.nb * hq), D, 0, s>>>(
      acc, ml, (const int32_t*)a.kl, (T*)a.o, hq, D, a.ps, a.n_pages,
      a.part, n_part, a.use_window, a.window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_group(const Args& a, cudaStream_t s) {
  if (a.g <= 1) return launch<T, D, 1>(a, s);
  if (a.g <= 2) return launch<T, D, 2>(a, s);
  if (a.g <= 4) return launch<T, D, 4>(a, s);
  return launch<T, D, 8>(a, s);   // larger groups take several blocks
}

template <typename T>
int by_dim(const Args& a, cudaStream_t s) {
  switch (a.d) {
    case 32: return by_group<T, 32>(a, s);
    case 64: return by_group<T, 64>(a, s);
    case 128: return by_group<T, 128>(a, s);
    case 256: return by_group<T, 256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [nb, hkv·g, d]; k/v pools [n_pool, ps, hkv, d]; page_table int32
// [nb, n_pages]; kv_len int32 [nb]; o [nb, hkv·g, d]; scratch float32
// [nb·hkv·g·n_part·(d + 2)], n_part = max(1, ceil(n_pages / part)) (unused
// when n_part is 1). dtype 0 = float32, 1 = bfloat16.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_len, void* o, void* scratch,
    int dtype, int nb, int hkv, int g, int d, int n_pool, int ps,
    int n_pages, int part, int use_window, int window, int use_softcap,
    float softcap, float scale, void* stream) {
  if (nb == 0 || hkv == 0 || g == 0) return (int)cudaGetLastError();
  if (part < 1) return (int)cudaErrorInvalidValue;
  const Args a{q,  k_pool, v_pool, page_table, kv_len, o,          scratch,
               nb, hkv,    g,      d,          n_pool, ps,         n_pages,
               part, use_window, window, use_softcap, softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == lm::DTYPE_F32) return by_dim<float>(a, s);
  if (dtype == lm::DTYPE_BF16) return by_dim<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
