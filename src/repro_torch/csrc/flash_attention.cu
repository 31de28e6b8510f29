// Flash attention: online-softmax attention with GQA, a causal mask, a
// sliding window and a logit softcap, accumulated in float32.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_folded (body
// _flash_kernel). The TPU walks k-blocks as a sequential grid axis with the
// softmax state in VMEM scratch; here one block owns a tile of query rows
// of one head for its whole life, loops over the key range that tile can
// see (so causal and window structure cost nothing outside it; the longest
// causal tiles start first) and keeps the state in registers.
//
// Layout: q [BHq, Sq, D], k/v [BHkv, Sk, D], out in q's dtype. Head bh
// reads K/V head bh / g. Softcap comes before the mask. A masked key has
// weight exactly 0, so a row that sees no key at all ends with l = 0 and
// its output is 0 (the TPU kernel's output there depends on its block
// size; the reference's is an average of every key).
//
// Bound: at full width the products dominate (4·D flops per visible
// query-key pair against bytes of q, k, v and o read or written once), so
// the bound is the card's bf16 tensor-core rate. The C entry picks one of
// two routes by dtype:
//
// bfloat16 (flash_tc_kernel; every full-width caller): the tensor cores.
// A block owns 128 query rows of one head: two consumer warpgroups of 64
// rows and a producer warp. The producer's one thread loads the block's Q
// once and K/V tiles of BK keys (64, or 32 at D = 256) of head bh / g
// through a three-stage ring of shared memory with TMA (3-D tensor maps
// over [BH, S, D]; rows past the sequence come back as zeros), each tile
// in 64-value column chunks with the 128-byte swizzle (64-byte at D = 32)
// that wgmma reads. S = Q·K^T is wgmma m64nBKk16 on the bf16 Q and K from
// shared memory (exact products, float32 sums), then × scale, softcap
// (tanh to ~1e-7), mask and the online max and sum in float32 registers.
// P·V is wgmma m64nDk16 with P from registers and V as the MN-major
// operand, run twice: P is split into P_hi = bf16(p) and P_lo = bf16(p −
// P_hi), because one bf16 rounding of P would move the output by about
// 2^-9 of each weight, beyond the float32 plain version's tolerance
// (kernels/tolerance.py); the split keeps it near 2^-17 at 1.5× the tensor
// work. Each consumer warp releases a stage once its products on it are
// done, so the two warpgroups run at their own pace and one's softmax
// overlaps the other's products; a warpgroup skips the products of a tile
// none of its rows can see and masks only tiles that cross a boundary.
// With the producer, a block holds three warpgroups' registers (168 a
// thread): the 64 × 256 accumulators of D = 256 spill a little.
//
// float32 (flash_kernel; the card tests): the first port, on the FMA
// units. Each warp owns 8 query rows; keys are staged bk at a time in
// shared memory; lane j computes key j's score of each 32 (a float4 walk
// over D against the 8 broadcast, scaled query rows), the row maxima and
// sums come from warp shuffles, the probabilities go through shared
// memory, and for P·V lane j owns D / 32 output dimensions of all 8 rows.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int ROWS = 8;   // query rows per warp
constexpr int KT = 32;    // keys per sub-tile: one per lane

// ---- float32 route: the FMA units -----------------------------------------
template <int D>
__global__ void __launch_bounds__(512, 1) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int sq, int sk, int g,
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
  const float* qb = q + (int64_t)bh * sq * D;
  const float* kb = k + (int64_t)(bh / g) * sk * D;
  const float* vb = v + (int64_t)(bh / g) * sk * D;

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
      float* orow = o + ((int64_t)bh * sq + qpos) * D + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d) orow[d] = acc[r][d] / lt;
    }
  }
}

// ---- bfloat16 route: the tensor cores ------------------------------------
constexpr int TC_WGS = 2;                          // consumer warpgroups
constexpr int TC_BQ = 64 * TC_WGS;                 // query rows a block
constexpr int TC_CONSUMERS = TC_WGS * 128;
constexpr int TC_THREADS = TC_CONSUMERS + 32;      // and one producer warp
constexpr int TC_STAGES = 3;                       // K/V ring depth
constexpr int TC_ALIGN = 1024;   // a swizzle atom (8 rows of 128 bytes)
constexpr int TC_BAR_BYTES = 8 * (1 + 3 * TC_STAGES);

template <int D>
__host__ __device__ constexpr int tc_bk() { return D <= 128 ? 64 : 32; }
// A tile of rows of D bf16 is stored as column chunks of CW values, each
// [rows][ROWB bytes] with the ROWB-byte swizzle TMA writes and wgmma reads:
// 128 bytes (64 values), or 64 (32 values) at D = 32.
template <int D>
__host__ __device__ constexpr int tc_rowb() { return D >= 64 ? 128 : 64; }
// the barriers, then Q, the K ring and the V ring aligned to an atom
template <int D>
__host__ __device__ constexpr int tc_smem() {
  return TC_BAR_BYTES + TC_ALIGN +
         2 * D * (TC_BQ + 2 * TC_STAGES * tc_bk<D>());
}

// tanh to about 1e-7: (1 − e) / (1 + e) with e = exp(−2|x|), which cannot
// overflow (tanh.approx.f32 is off by ~2^-11, 0.02 on a logit capped at 50)
__device__ __forceinline__ float tanh_acc(float x) {
  const float e = __expf(-2.f * fabsf(x));
  return copysignf(__fdividef(1.f - e, 1.f + e), x);
}

// mq, mk, mv: tensor maps of q [BHq][Sq][D] and k, v [BHkv][Sk][D], boxes
// of CW columns by 64 query rows or BK keys. One producer thread loads the
// block's Q once (q_full) and keeps TC_STAGES K/V tiles in flight (full_k,
// full_v count their bytes); each consumer warp releases a stage (empty)
// once its products on it are done, so the two warpgroups run at their
// own pace and one's softmax overlaps the other's products.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_tc_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ o,
    int sq, int sk, int g, int causal, int use_window, int window,
    int use_softcap, float softcap, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = tc_bk<D>(), ROWB = tc_rowb<D>(), CW = ROWB / 2;
  constexpr int NCH = D / CW;
  constexpr int SWIZZLE = ROWB == 128 ? 1 : 2;   // descriptor layout type
  constexpr int TILE = BK * 2 * D;               // bytes of a K or V tile
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  uint64_t* q_full = reinterpret_cast<uint64_t*>(tc_smem_raw);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + TC_STAGES;
  uint64_t* empty = full_v + TC_STAGES;
  unsigned char* s_q = tc_smem_raw + TC_BAR_BYTES;   // [NCH][TC_BQ][ROWB]
  s_q += (TC_ALIGN - (tma::smem(s_q) & (TC_ALIGN - 1))) & (TC_ALIGN - 1);
  unsigned char* s_k = s_q + TC_BQ * 2 * D;   // [STAGES][NCH][BK][ROWB]
  unsigned char* s_v = s_k + TC_STAGES * TILE;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(sk, min(q0 + TC_BQ, sq));
  if (use_window) k_begin = max(0, q0 - window + 1);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (tid == 0) {
    tma::init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      tma::init(&full_k[s], 1);
      tma::init(&full_v[s], 1);
      tma::init(&empty[s], TC_CONSUMERS / 32);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {   // the producer warp; one thread issues
    if (tid == TC_CONSUMERS) {
      tma::arrive_expect(q_full, TC_BQ * 2 * D);
      for (int w = 0; w < TC_WGS; ++w)
        for (int ch = 0; ch < NCH; ++ch)
          tma::load(s_q + ch * TC_BQ * ROWB + w * 64 * ROWB, &mq, ch * CW,
                    q0 + 64 * w, bh, q_full);
      // past the last tile: wait until every stage is released
      for (int j = 0; j < n_tiles + TC_STAGES; ++j) {
        const int st = j % TC_STAGES, kt = k_begin + j * BK;
        tma::wait(&empty[st], ((j / TC_STAGES) & 1) ^ 1);
        if (j >= n_tiles) continue;
        tma::arrive_expect(&full_k[st], TILE);
        for (int ch = 0; ch < NCH; ++ch)
          tma::load(s_k + st * TILE + ch * BK * ROWB, &mk, ch * CW, kt,
                    bh / g, &full_k[st]);
        tma::arrive_expect(&full_v[st], TILE);
        for (int ch = 0; ch < NCH; ++ch)
          tma::load(s_v + st * TILE + ch * BK * ROWB, &mv, ch * CW, kt,
                    bh / g, &full_v[st]);
      }
    }
    return;
  }

  const int wgi = tid >> 7, lane = tid & 31;
  const int w_first = q0 + wgi * 64, w_last = w_first + 63;   // the group's
  const int row = w_first + (tid >> 5 & 3) * 16 + (lane >> 2);   // +0, +8
  const float inv_cap = use_softcap ? 1.f / softcap : 0.f;
  float acc[D / 2];   // O: [4·(d / 8) + c], the wgmma m64nD layout
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};   // this thread's share of each row's sum
  tma::wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % TC_STAGES;
    const uint32_t par = (j / TC_STAGES) & 1;
    const int kt = k_begin + j * BK;
    const unsigned char* tk = s_k + st * TILE;
    const unsigned char* tv = s_v + st * TILE;
    // warpgroup-uniform: does any row of the group see a key of this
    // tile, and do all of them see all of it
    bool none = w_first >= sq;
    if (causal) none = none || kt > w_last;
    if (use_window) none = none || w_first - (kt + BK - 1) >= window;
    bool full = kt + BK <= k_end;
    if (causal) full = full && kt + BK - 1 <= w_first;
    if (use_window) full = full && w_last - kt < window;

    tma::wait(&full_k[st], par);
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
    if (!none) {
      // S = Q·K^T: [4·(key / 8) + c], the wgmma m64nBK layout
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      wg::hold(s);
      wg::fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const int ch = kd * 16 / CW, off = (kd * 16 % CW) * 2;
        wg::mma_ss<0>(
            s,
            wg::desc(s_q + ch * TC_BQ * ROWB + wgi * 64 * ROWB + off, 16,
                     8 * ROWB, SWIZZLE),
            wg::desc(tk + ch * BK * ROWB + off, 16, 8 * ROWB, SWIZZLE));
      }
      wg::commit();
      wg::wait<0>();
      wg::hold(s);

      // scale, softcap, mask; s[4·nt + i] is (row + 8·(i / 2), key kt +
      // 8·nt + 2·(lane % 4) + i % 2)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[4 * nt + i] * scale;
          if (use_softcap) x = softcap * tanh_acc(x * inv_cap);
          if (!full) {
            const int qpos = row + (i >> 1) * 8;
            const int kpos = kt + nt * 8 + 2 * (lane & 3) + (i & 1);
            bool vis = kpos < k_end;
            if (causal) vis = vis && kpos <= qpos;
            if (use_window) vis = vis && qpos - kpos < window;
            if (!vis) x = -INFINITY;
          }
          s[4 * nt + i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
        }
      float mu[2], corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xFFFFFFFFu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xFFFFFFFFu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        mu[h] = m_new == -INFINITY ? 0.f : m_new;   // no key seen yet
        corr[h] = exp2f((m_run[h] - mu[h]) * LOG2E);
        m_run[h] = m_new;
        l_run[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      // P_hi and P_lo as the register A fragments of 16 keys each
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = exp2f((s[4 * nt + i] - mu[i >> 1]) * LOG2E);
          l_run[i >> 1] += p[i];
        }
        const int kc = nt >> 1, half = (nt & 1) * 2;
        wg::split(p[0], p[1], ph[kc][half], pl[kc][half]);
        wg::split(p[2], p[3], ph[kc][half + 1], pl[kc][half + 1]);
      }
    }

    tma::wait(&full_v[st], par);
    if (!none) {
      // O += P_hi·V + P_lo·V; V is the MN-major B operand (N = D)
      wg::hold(acc);
      wg::fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint64_t dv = wg::desc(tv + kc * 16 * ROWB, BK * ROWB, 8 * ROWB,
                                     SWIZZLE);
        wg::mma_rs<1>(acc, ph[kc], dv);
        wg::mma_rs<1>(acc, pl[kc], dv);
      }
      wg::commit();
      wg::wait<0>();
      wg::hold(acc);
    }
    __syncwarp();
    if (lane == 0) tma::arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xFFFFFFFFu, l, 1);
    l += __shfl_xor_sync(0xFFFFFFFFu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int qpos = row + h * 8;
    if (qpos < sq) {
      bf16* orow = o + ((int64_t)bh * sq + qpos) * D + 2 * (lane & 3);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            wg::pack(acc[4 * dt + 2 * h] * inv, acc[4 * dt + 2 * h + 1] * inv);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int64_t bhq;
  int sq, sk, g, causal, use_window, window, use_softcap;
  float softcap, scale;
  int bq, bk, smem;
  cudaStream_t stream;
};

template <typename K>
int set_smem(K kern, int smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
int launch_f32(const Args& a) {
  if (int err = set_smem(flash_kernel<D>, a.smem)) return err;
  const dim3 grid((unsigned)((a.sq + a.bq - 1) / a.bq), (unsigned)a.bhq);
  flash_kernel<D><<<grid, (a.bq / ROWS) * 32, a.smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      a.sq, a.sk, a.g, a.causal, a.use_window, a.window, a.use_softcap,
      a.softcap, a.scale, a.bq, a.bk);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Args& a) {
  constexpr int CW = tc_rowb<D>() / 2;
  // the wrapper's tiles and shared memory must be this route's own
  if (a.bq != TC_BQ || a.bk != tc_bk<D>() || a.smem != tc_smem<D>())
    return (int)cudaErrorInvalidValue;
  if (a.sk == 0)   // no key: every row is 0
    return (int)cudaMemsetAsync(a.o, 0, (size_t)a.bhq * a.sq * D * 2,
                                a.stream);
  CUtensorMap mq, mk, mv;
  int err = tma::map3d(&mq, a.q, D, a.sq, a.bhq, CW, 64);
  if (!err) err = tma::map3d(&mk, a.k, D, a.sk, a.bhq / a.g, CW, tc_bk<D>());
  if (!err) err = tma::map3d(&mv, a.v, D, a.sk, a.bhq / a.g, CW, tc_bk<D>());
  if (err) return err;
  if (int e = set_smem(flash_tc_kernel<D>, a.smem)) return e;
  const dim3 grid((unsigned)((a.sq + TC_BQ - 1) / TC_BQ), (unsigned)a.bhq);
  flash_tc_kernel<D><<<grid, TC_THREADS, a.smem, a.stream>>>(
      mq, mk, mv, (__nv_bfloat16*)a.o, a.sq, a.sk, a.g, a.causal,
      a.use_window, a.window, a.use_softcap, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const Args& a) {
  if (dtype == lm::DTYPE_F32) return launch_f32<D>(a);
  if (dtype == lm::DTYPE_BF16) return launch_bf16<D>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [bhq, sq, d], k/v [bhq / g, sk, d], o [bhq, sq, d]; dtype 0 = float32
// (the FMA route: bq a multiple of 8 up to 128, bk a multiple of 32), 1 =
// bfloat16 (the tensor-core route: bq = 128 and bk = 64, or 32 at d = 256,
// its own tiles); smem the dynamic shared memory those sizes need (the
// wrapper computes it; the bf16 route refuses any other value).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int64_t bhq, int sq, int sk, int d, int g, int causal, int use_window,
    int window, int use_softcap, float softcap, float scale, int bq, int bk,
    int smem, void* stream) {
  if (bhq == 0 || sq == 0) return (int)cudaGetLastError();
  const Args a{q, k, v, o, bhq, sq, sk, g, causal, use_window, window,
               use_softcap, softcap, scale, bq, bk, smem,
               (cudaStream_t)stream};
  switch (d) {
    case 32: return launch<32>(dtype, a);
    case 64: return launch<64>(dtype, a);
    case 128: return launch<128>(dtype, a);
    case 256: return launch<256>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
