// Grouped expert FFN: per expert e, out[e] = (act(x[e] @ w_gate[e]) *
// (x[e] @ w_in[e])) @ w_out[e], with act = silu or gelu (tanh approximation,
// JAX's default), or sq_relu, which ignores the gate: relu(x @ w_in)^2 @
// w_out. Products and the activation are float32; the output is cast to
// x's dtype at the end.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py:moe_gmm (body
// _gmm_kernel). The TPU fuses the three products over blocks of F with the
// [bc, D] output accumulated in VMEM. Here that accumulator fits neither
// registers nor shared memory, so the intermediate a·h goes through global
// memory between two launches on one stream, batched over experts by
// blockIdx.z:
//   1. gate/up: a·h [E, C, F] = act(x @ w_gate) * (x @ w_in), both products
//      from one staged tile of x;
//   2. down: out [E, C, D] = a·h @ w_out.
// Ragged edges are masked, so no F column is padded; a zero-padded column
// of the caller's would add act(0)·0 = 0 exactly.
//
// Bound: operations — 2·E·C·D·F flops per product (three products, two for
// sq_relu) against one read of x and the weights: the card's bf16
// tensor-core rate. The C entry picks one of two routes by dtype:
//
// bfloat16 (gmm_tc_kernel; every full-width caller): one tensor-core GEMM
// core. A block computes a 128 × 128 output tile with two consumer
// warpgroups of 64 rows (wgmma m64n128k16, float32 accumulators) and a
// producer warp whose one thread streams K 64 deep through a four-stage
// ring of shared memory with TMA (3-D tensor maps over [E, rows, cols];
// loads past C, D or F come back as zeros, so ragged edges need no
// padding: D and F must be multiples of 8 for TMA's 16-byte rows, which
// the wrapper checks). x is the K-major operand and the row-major weights
// the MN-major one, both with the 128-byte swizzle. Launch 1 keeps the
// gate and up products of one tile in two accumulators from the same
// staged x (sq_relu reads no w_gate) and its float32 epilogue writes a·h
// as two bf16 planes, hi = bf16(a·h) and lo = bf16(a·h − hi): one bf16
// rounding of a·h would move the output beyond the float32 plain
// version's tolerance (kernels/tolerance.py); the pair keeps a·h to about
// 2^-17 and takes the 4 bytes an element that a float32 scratch would.
// Launch 2 stages each w_out tile once and feeds it to two products,
// hi·w_out and lo·w_out, into one float32 accumulator: 4/3 of the tensor
// work of the three products.
//
// float32 (gmm_kernel; the card tests): the first port, one tiled SIMT
// GEMM (64 × 64 output tile per block of 256 threads, 4 × 4 outputs per
// thread, K staged 16 at a time in shared memory) on the FMA units, with a
// float32 a·h scratch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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

// ---- float32 route: the FMA units -----------------------------------------
// C[e] = A[e] (M × K) @ B0[e] (K × N), and with two products also
// A[e] @ B1[e]; both row-major. The epilogue of `mode` writes the
// activation (the gate/up stage) or the product (the down stage) to
// out[e] (M × N).
template <int MODE>
__global__ void __launch_bounds__(THREADS) gmm_kernel(
    const float* __restrict__ A, const float* __restrict__ B0,
    const float* __restrict__ B1, float* __restrict__ out, int M, int N,
    int K) {
  constexpr bool DUAL = MODE == SILU || MODE == GELU;
  __shared__ float4 a_s4[BK * BM / 4];     // A tile, transposed: [BK][BM]
  __shared__ float4 b0_s4[BK * BN / 4];    // [BK][BN]
  __shared__ float4 b1_s4[DUAL ? BK * BN / 4 : 1];
  float* a_s = reinterpret_cast<float*>(a_s4);
  float* b0_s = reinterpret_cast<float*>(b0_s4);
  float* b1_s = reinterpret_cast<float*>(b1_s4);

  const int e = blockIdx.z;
  const float* Ae = A + (int64_t)e * M * K;
  const float* B0e = B0 + (int64_t)e * K * N;
  const float* B1e = DUAL ? B1 + (int64_t)e * K * N : nullptr;
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
          gm < M && gk < K ? Ae[(int64_t)gm * K + gk] : 0.f;
      const int gk2 = k0 + br, gn = n0 + bc + i;
      const bool inb = gk2 < K && gn < N;
      b0_s[br * BN + bc + i] = inb ? B0e[(int64_t)gk2 * N + gn] : 0.f;
      if constexpr (DUAL)
        b1_s[br * BN + bc + i] = inb ? B1e[(int64_t)gk2 * N + gn] : 0.f;
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
        out[at] = acc0[i][j];
      } else if constexpr (MODE == SQ_RELU) {
        const float r = fmaxf(acc0[i][j], 0.f);
        out[at] = r * r;
      } else if constexpr (MODE == SILU) {
        out[at] = silu(acc0[i][j]) * acc1[i][j];
      } else {
        out[at] = gelu_tanh(acc0[i][j]) * acc1[i][j];
      }
    }
  }
}

template <int MODE>
int gemm(const float* A, const float* B0, const float* B1, float* out, int E,
         int M, int N, int K, cudaStream_t s) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)E);
  gmm_kernel<MODE><<<grid, THREADS, 0, s>>>(A, B0, B1, out, M, N, K);
  return (int)cudaGetLastError();
}

int run_f32(const float* x, const float* wg, const float* wi,
            const float* wo, float* ah, float* out, int E, int C, int D,
            int F, int act, cudaStream_t s) {
  int err;
  if (act == SILU)
    err = gemm<SILU>(x, wg, wi, ah, E, C, F, D, s);
  else if (act == GELU)
    err = gemm<GELU>(x, wg, wi, ah, E, C, F, D, s);
  else if (act == SQ_RELU)
    err = gemm<SQ_RELU>(x, wi, nullptr, ah, E, C, F, D, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  return gemm<DOWN>(ah, wo, nullptr, out, E, C, D, F, s);
}

// ---- bfloat16 route: the tensor cores ------------------------------------
constexpr int TBM = 128, TBN = 128, TBK = 64, TSTAGES = 4;
constexpr int TCONSUMERS = 256;             // two warpgroups of 64 rows each
constexpr int TTHREADS = TCONSUMERS + 32;   // and one producer warp
// Tiles as TMA writes them with the 128-byte swizzle (16-byte chunk c of a
// 128-byte row r stored at chunk c ^ r % 8): A [TBM rows][TBK], K-major; B
// [2 column chunks][TBK rows][64], MN-major.
constexpr int A_TILE = TBM * TBK * 2, B_CHUNK = TBK * 64 * 2;
constexpr int B_TILE = 2 * B_CHUNK;
constexpr int ALIGN = 1024;   // a swizzle atom: 8 rows of 128 bytes
constexpr int BAR_BYTES = 2 * TSTAGES * 8;

__host__ __device__ constexpr int tc_n_a(int mode) {
  return mode == DOWN ? 2 : 1;
}
__host__ __device__ constexpr int tc_n_b(int mode) {
  return mode == SILU || mode == GELU ? 2 : 1;
}
__host__ __device__ constexpr int tc_stage_bytes(int mode) {
  return tc_n_a(mode) * A_TILE + tc_n_b(mode) * B_TILE;
}
// the barriers, the ring and the slack to align the ring to an atom
constexpr int tc_smem(int mode) {
  return BAR_BYTES + ALIGN + TSTAGES * tc_stage_bytes(mode);
}

// out = A @ B per expert, bf16 in, from tensor maps of A [E][M][K] (ma0;
// DOWN: the hi plane, and the lo plane in ma1) and B [E][K][N] (mb0, and
// w_in in mb1 for silu and gelu): gate/up modes write the activation's hi
// and lo planes (out0, out1), DOWN writes out0 = hi @ B0 + lo @ B0.
// One producer thread keeps TSTAGES tiles of K in flight through TMA
// (full[s] counts a stage's bytes); each consumer warp releases a stage
// (empty[s]) once the wgmma that reads it has completed.
template <int MODE>
__global__ void __launch_bounds__(TTHREADS, 1) gmm_tc_kernel(
    const __grid_constant__ CUtensorMap ma0,
    const __grid_constant__ CUtensorMap ma1,
    const __grid_constant__ CUtensorMap mb0,
    const __grid_constant__ CUtensorMap mb1, __nv_bfloat16* __restrict__ out0,
    __nv_bfloat16* __restrict__ out1, int M, int N, int K) {
  constexpr int NA = tc_n_a(MODE), NB = tc_n_b(MODE);
  constexpr int STAGE = tc_stage_bytes(MODE);
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(tc_smem_raw);
  uint64_t* empty = full + TSTAGES;
  unsigned char* ring = tc_smem_raw + BAR_BYTES;
  ring += (ALIGN - (tma::smem(ring) & (ALIGN - 1))) & (ALIGN - 1);

  const int e = blockIdx.z, tid = threadIdx.x;
  // consecutive blocks share a column tile of B, so each weight tile comes
  // from device memory about once and the rows of A from L2
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  const int n_k = (K + TBK - 1) / TBK;
  if (tid == 0) {
    for (int s = 0; s < TSTAGES; ++s) {
      tma::init(&full[s], 1);
      tma::init(&empty[s], TCONSUMERS / 32);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (tid >= TCONSUMERS) {   // the producer warp; one thread issues
    if (tid == TCONSUMERS) {
      const CUtensorMap* ma[2] = {&ma0, &ma1};
      const CUtensorMap* mb[2] = {&mb0, &mb1};
      // past the last tile: wait until every stage is released
      for (int kt = 0; kt < n_k + TSTAGES; ++kt) {
        const int st = kt % TSTAGES;
        tma::wait(&empty[st], ((kt / TSTAGES) & 1) ^ 1);
        if (kt >= n_k) continue;
        unsigned char* dst = ring + st * STAGE;
        tma::arrive_expect(&full[st], STAGE);
#pragma unroll
        for (int t = 0; t < NA; ++t)
          tma::load(dst + t * A_TILE, ma[t], kt * TBK, m0, e, &full[st]);
#pragma unroll
        for (int t = 0; t < NB; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tma::load(dst + NA * A_TILE + t * B_TILE + c * B_CHUNK, mb[t],
                      n0 + 64 * c, kt * TBK, e, &full[st]);
      }
    }
    return;
  }

  const int wgi = tid >> 7, lane = tid & 31;
  const int wrow = (tid >> 5 & 3) * 16;   // the warp's rows in its group
  constexpr int NACC = NB;                // gate and up, or one
  float acc[NACC][TBN / 2];
#pragma unroll
  for (int t = 0; t < NACC; ++t)
#pragma unroll
    for (int i = 0; i < TBN / 2; ++i) acc[t][i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % TSTAGES;
    tma::wait(&full[st], (kt / TSTAGES) & 1);
    const unsigned char* sa = ring + st * STAGE;
#pragma unroll
    for (int t = 0; t < NACC; ++t) wg::hold(acc[t]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      uint64_t da[NA], db[NB];
#pragma unroll
      for (int t = 0; t < NA; ++t)
        da[t] = wg::desc(sa + t * A_TILE + wgi * 64 * 128 + kk * 32, 16,
                         1024, 1);
#pragma unroll
      for (int t = 0; t < NB; ++t)
        db[t] = wg::desc(sa + NA * A_TILE + t * B_TILE + kk * 2048, B_CHUNK,
                         1024, 1);
      if constexpr (MODE == DOWN) {
        wg::mma_ss<1>(acc[0], da[0], db[0]);
        wg::mma_ss<1>(acc[0], da[1], db[0]);
      } else {
#pragma unroll
        for (int t = 0; t < NB; ++t) wg::mma_ss<1>(acc[t], da[0], db[t]);
      }
    }
    wg::commit();
    wg::wait<1>();   // the previous stage's products are done: release it
#pragma unroll
    for (int t = 0; t < NACC; ++t) wg::hold(acc[t]);
    if (kt > 0 && lane == 0) tma::arrive(&empty[(kt - 1) % TSTAGES]);
  }
  wg::wait<0>();
#pragma unroll
  for (int t = 0; t < NACC; ++t) wg::hold(acc[t]);
  if (n_k > 0 && lane == 0) tma::arrive(&empty[(n_k - 1) % TSTAGES]);

  // acc[.][4j + c] is (row m0 + 64·group + wrow + lane/4 + 8·(c / 2), col
  // n0 + 8j + 2·(lane % 4) + c % 2); N is even, so a pair is in or out
  // together
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + wgi * 64 + wrow + (lane >> 2) + h * 8;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TBN / 8; ++j) {
      const int gn = n0 + j * 8 + 2 * (lane & 3);
      if (gn >= N) continue;
      const int64_t at = ((int64_t)e * M + gm) * N + gn;
      const float* c0 = &acc[0][4 * j + 2 * h];
      if constexpr (MODE == DOWN) {
        *reinterpret_cast<uint32_t*>(out0 + at) = wg::pack(c0[0], c0[1]);
      } else {
        float y[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if constexpr (MODE == SQ_RELU) {
            const float r = fmaxf(c0[u], 0.f);
            y[u] = r * r;
          } else {
            const float up = acc[NACC - 1][4 * j + 2 * h + u];
            y[u] = (MODE == SILU ? silu(c0[u]) : gelu_tanh(c0[u])) * up;
          }
        }
        uint32_t hi, lo;
        wg::split(y[0], y[1], hi, lo);
        *reinterpret_cast<uint32_t*>(out0 + at) = hi;
        *reinterpret_cast<uint32_t*>(out1 + at) = lo;
      }
    }
  }
}

template <int MODE>
int gemm_tc(const __nv_bfloat16* A0, const __nv_bfloat16* A1,
            const __nv_bfloat16* B0, const __nv_bfloat16* B1,
            __nv_bfloat16* out0, __nv_bfloat16* out1, int E, int M, int N,
            int K, int smem, cudaStream_t s) {
  if (smem != tc_smem(MODE)) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (K == 0)   // an empty sum (the down product of F = 0)
    return (int)cudaMemsetAsync(out0, 0, (size_t)E * M * N * 2, s);
  CUtensorMap ma0, ma1, mb0, mb1;
  int err = tma::map3d(&ma0, A0, K, M, E, TBK, TBM);
  if (!err) err = tma::map3d(&mb0, B0, N, K, E, 64, TBK);
  ma1 = ma0;
  mb1 = mb0;
  if (!err && A1) err = tma::map3d(&ma1, A1, K, M, E, TBK, TBM);
  if (!err && B1) err = tma::map3d(&mb1, B1, N, K, E, 64, TBK);
  if (err) return err;
  cudaError_t ce = cudaFuncSetAttribute(
      gmm_tc_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((unsigned)((M + TBM - 1) / TBM),
                  (unsigned)((N + TBN - 1) / TBN), (unsigned)E);
  gmm_tc_kernel<MODE><<<grid, TTHREADS, smem, s>>>(ma0, ma1, mb0, mb1, out0,
                                                   out1, M, N, K);
  return (int)cudaGetLastError();
}

int run_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wg,
             const __nv_bfloat16* wi, const __nv_bfloat16* wo,
             __nv_bfloat16* ah, __nv_bfloat16* out, int E, int C, int D,
             int F, int act, int smem_up, int smem_down, cudaStream_t s) {
  if (D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  __nv_bfloat16* hi = ah;
  __nv_bfloat16* lo = ah + (int64_t)E * C * F;
  int err;
  if (act == SILU)
    err = gemm_tc<SILU>(x, nullptr, wg, wi, hi, lo, E, C, F, D, smem_up, s);
  else if (act == GELU)
    err = gemm_tc<GELU>(x, nullptr, wg, wi, hi, lo, E, C, F, D, smem_up, s);
  else if (act == SQ_RELU)
    err = gemm_tc<SQ_RELU>(x, nullptr, wi, nullptr, hi, lo, E, C, F, D,
                           smem_up, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  return gemm_tc<DOWN>(hi, lo, wo, nullptr, out, nullptr, E, C, D, F,
                       smem_down, s);
}

}  // namespace

// x [E, C, D]; w_gate, w_in [E, D, F]; w_out [E, F, D]; out [E, C, D] in
// x's dtype; act 0 = silu, 1 = gelu (tanh), 2 = sq_relu. dtype 0 = float32
// (the FMA route: ah a float32 [E, C, F] scratch; smem_up and smem_down
// unused), 1 = bfloat16 (the tensor-core route: ah the bf16 planes
// [2, E, C, F], hi then lo; D and F multiples of 8; smem_up and smem_down
// the dynamic shared memory of the gate/up and down launches, which the
// wrapper computes and this route checks).
extern "C" int moe_gmm_launch(const void* x, const void* w_gate,
                              const void* w_in, const void* w_out, void* ah,
                              void* out, int dtype, int E, int C, int D,
                              int F, int act, int smem_up, int smem_down,
                              void* stream) {
  if (E == 0 || C == 0 || D == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == lm::DTYPE_F32)
    return run_f32((const float*)x, (const float*)w_gate,
                   (const float*)w_in, (const float*)w_out, (float*)ah,
                   (float*)out, E, C, D, F, act, s);
  if (dtype == lm::DTYPE_BF16)
    return run_bf16((const __nv_bfloat16*)x, (const __nv_bfloat16*)w_gate,
                    (const __nv_bfloat16*)w_in, (const __nv_bfloat16*)w_out,
                    (__nv_bfloat16*)ah, (__nv_bfloat16*)out, E, C, D, F, act,
                    smem_up, smem_down, s);
  return (int)cudaErrorInvalidValue;
}
