// Selective scan (Mamba SSM): per channel d and state n,
//   a = exp(dt · -exp(A_log[d, n])),  b = dt · x · B[n],
//   h ← a ⊙ h + b,                    y = Σ_n h · C[n] + D_skip[d] · x,
// with h starting at zero and carried across the whole sequence. Given
// h_last, each lane also writes its states after the last step there (the
// state a decode cache carries on from).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py:mamba_scan
// (body _scan_kernel). As there, a and b never reach device memory and
// dt · x is taken in float32. The TPU steps through chunks as a sequential
// grid axis with h in VMEM scratch; here LPS = 2 lanes own one (batch,
// channel), N / 2 states each in registers, and walk the sequence
// themselves, adding their parts of y with one shuffle a step. Two lanes
// a channel give jamba's 16,384 channels two warps a scheduler; on the
// H100 that ran faster than one lane and than four (PERF.md §6).
//
// Bound: the exponentials — B·S·Di·N of them on the MUFU (16 a clock per
// SM on compute capability 9.0) — above the bytes of dt, x, B, C and y read
// or written once. The design spends one MUFU op per (step, channel,
// state): log2(e) is folded into A once per (channel, state), A being
// -exp(A_log) by the accurate expf, and a = 2^(dt·A) is one ex2.approx;
// the state update and the y sum are FMAs, whose unit has 8 times the
// MUFU's rate. What else a step issues is kept small, since each warp
// scheduler issues one instruction a clock: a block stages `chunk` steps
// at a time — its channels' dt and x, its batch row's B and C — through a
// ring of NSTG = 3 stages in shared memory by 16-byte cp.async copies, two
// chunks ahead of the one it computes (one barrier a chunk); B and C are
// widened to float32 once a chunk for every lane that reads them, and the
// chunk's y is gathered in shared memory and written out in 16-byte
// stores during the next chunk, so a step reads shared memory and does no
// address arithmetic or conversion of B and C. Within a chunk a step's
// operands are read, and its a taken, while the step before updates its
// states, and 16 steps are unrolled: the MUFU ops and the FMAs are then
// independent enough to interleave with two warps a scheduler. The last
// step of a chunk looks ahead to itself, so a chunk of 64 steps takes 65
// steps' exps; both ways of saving that one (a select of the next chunk's
// dt a step, or a dt row copied after the chunk) ran slower on the H100
// (PERF.md §6). N is a
// template constant: the wrapper pads B, C and A_log to it (and Di to
// whole 16-byte copies).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace {

constexpr int NSTG = 3;          // ring stages (ops.py mirrors it)
constexpr int LPS = 2;           // lanes a channel (ops.py mirrors it)
constexpr int MAX_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int N>
__global__ void __launch_bounds__(MAX_THREADS) scan_kernel(
    const T* __restrict__ dt, const T* __restrict__ x,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ A_log, const float* __restrict__ D_skip,
    T* __restrict__ y, float* __restrict__ h_last, int S, int Di,
    int chunk) {
  constexpr int NPL = N / LPS;                 // states a lane
  constexpr int EPC = 16 / (int)sizeof(T);     // elements a 16-byte copy
  constexpr int VB = NPL < 8 ? NPL : 8;        // B, C values read at once
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthr = blockDim.x, bd = nthr / LPS;
  // a stage: dt [chunk][bd], x [chunk][bd], B [chunk][N], C [chunk][N]
  const int stage = 2 * chunk * (bd + N);
  T* ring = reinterpret_cast<T*>(smem);
  // B and C widened: [2][2][chunk][N]; y: [2][chunk][bd]
  float* fbc = reinterpret_cast<float*>(ring + NSTG * stage);
  T* ybuf = reinterpret_cast<T*>(fbc + 4 * chunk * N);

  const int b = blockIdx.y, d0 = blockIdx.x * bd;
  const int ch = threadIdx.x / LPS, sub = threadIdx.x % LPS;
  const int d = d0 + ch;
  const bool live = d < Di;
  const int n0 = sub * NPL;

  float A2[NPL], h[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    A2[j] = live ? -expf(A_log[(int64_t)d * N + n0 + j]) * LOG2E : 0.f;
    h[j] = 0.f;
  }
  const float dskip = live ? D_skip[d] : 0.f;

  const int64_t row0 = (int64_t)b * S;
  const int n_chunks = S / chunk;
  const int pieces = bd / EPC;                 // copies of a step's channels
  const int live_pieces = min(pieces, (Di - d0) / EPC);
  const int bc_pieces = chunk * N / EPC;       // copies of B (or C) a chunk
  auto issue = [&](int k) {
    T* st = ring + (k % NSTG) * stage;
    const int64_t t0 = row0 + (int64_t)k * chunk;
    for (int i = threadIdx.x; i < 2 * chunk * pieces; i += nthr) {
      const int mat = i >= chunk * pieces, r = i - mat * chunk * pieces;
      const int t = r / pieces, pc = r % pieces;
      const bool in = pc < live_pieces;
      lm::cp_async16(st + (mat * chunk + t) * bd + pc * EPC,
                     (mat ? x : dt) + (in ? (t0 + t) * Di + d0 + pc * EPC : 0),
                     in ? 16 : 0);
    }
    T* sbc = st + 2 * chunk * bd;
    for (int i = threadIdx.x; i < 2 * bc_pieces; i += nthr) {
      const int mat = i >= bc_pieces, pc = i - mat * bc_pieces;
      lm::cp_async16(sbc + mat * chunk * N + pc * EPC,
                     (mat ? Cm : Bm) + t0 * N + pc * EPC);
    }
  };
  // chunk k's B and C, arrived, widened once for every lane that reads them
  auto widen = [&](int k) {
    const T* src = ring + (k % NSTG) * stage + 2 * chunk * bd;
    float* dst = fbc + (k & 1) * 2 * chunk * N;
    for (int i = threadIdx.x; i < 2 * chunk * N; i += nthr)
      dst[i] = lm::to_f(src[i]);
  };
  auto store_y = [&](int k) {
    const T* yb = ybuf + (k & 1) * chunk * bd;
    const int64_t t0 = row0 + (int64_t)k * chunk;
    for (int i = threadIdx.x; i < chunk * pieces; i += nthr) {
      const int t = i / pieces, pc = i % pieces;
      if (pc < live_pieces)
        *reinterpret_cast<uint4*>(y + (t0 + t) * Di + d0 + pc * EPC) =
            *reinterpret_cast<const uint4*>(yb + t * bd + pc * EPC);
    }
  };

  // Chunk k computes from stage k % NSTG (dt, x) and fbc[k & 1] (B, C);
  // meanwhile chunk k + 1 has arrived and is widened, and chunk k + 2 is
  // in flight.
  issue(0);
  lm::cp_async_commit();
  if (n_chunks > 1) issue(1);
  lm::cp_async_commit();
  lm::cp_async_wait<1>();
  __syncthreads();
  widen(0);
  for (int k = 0; k < n_chunks; ++k) {
    lm::cp_async_wait<0>();   // chunk k + 1's copies, this thread's
    __syncthreads();          // ... every thread's; chunk k - 1 done
    if (k > 0) store_y(k - 1);
    if (k + 1 < n_chunks) widen(k + 1);
    if (k + 2 < n_chunks) issue(k + 2);
    lm::cp_async_commit();
    const T* sdt = ring + (k % NSTG) * stage + ch;
    const T* sx = sdt + chunk * bd;
    const float* sB = fbc + (k & 1) * 2 * chunk * N + n0;
    const float* sC = sB + chunk * N;
    T* yb = ybuf + (k & 1) * chunk * bd + ch;
    // A step's operands are read while the step before computes (the y
    // store ends a step, and the compiler keeps later reads behind it);
    // with 32 states a lane or more, B and C are read in place instead.
    constexpr int NB = NPL <= 16 ? NPL : 1;
    float dtn, xn, bn[NB], cn[NB];
    auto read = [&](int t) {
      dtn = lm::to_f(sdt[t * bd]);
      xn = lm::to_f(sx[t * bd]);
      if constexpr (NB == NPL) {
#pragma unroll
        for (int j0 = 0; j0 < NPL; j0 += VB) {
          lm::load_row<VB>(sB + t * N + j0, bn + j0);
          lm::load_row<VB>(sC + t * N + j0, cn + j0);
        }
      }
    };
    read(0);
    // with B and C read ahead, the next step's a is taken on the MUFU while
    // this step's FMAs run (independent, so they can interleave)
    float an[NB];
    if constexpr (NB == NPL) {
#pragma unroll
      for (int j = 0; j < NPL; ++j) an[j] = ex2(dtn * A2[j]);
    }
#pragma unroll 16
    for (int t = 0; t < chunk; ++t) {
      const float dtv = dtn, xv = xn, dx = dtv * xv;
      float acc[2] = {0.f, 0.f};   // two sums: half the dependent adds
      if constexpr (NB == NPL) {
        float a[NPL], bb[NPL], cc[NPL];
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          a[j] = an[j];
          bb[j] = bn[j];
          cc[j] = cn[j];
        }
        read(min(t + 1, chunk - 1));
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          an[j] = ex2(dtn * A2[j]);
          h[j] = fmaf(a[j], h[j], dx * bb[j]);
          acc[j & 1] = fmaf(h[j], cc[j], acc[j & 1]);
        }
      } else {
        read(min(t + 1, chunk - 1));
#pragma unroll
        for (int j0 = 0; j0 < NPL; j0 += VB) {
          float bb[VB], cc[VB];
          lm::load_row<VB>(sB + t * N + j0, bb);
          lm::load_row<VB>(sC + t * N + j0, cc);
#pragma unroll
          for (int j = 0; j < VB; ++j) {
            h[j0 + j] = fmaf(ex2(dtv * A2[j0 + j]), h[j0 + j], dx * bb[j]);
            acc[j & 1] = fmaf(h[j0 + j], cc[j], acc[j & 1]);
          }
        }
      }
      float yv = acc[0] + acc[1];
#pragma unroll
      for (int o = 1; o < LPS; o <<= 1)
        yv += __shfl_xor_sync(0xFFFFFFFFu, yv, o);
      if (sub == 0) yb[t * bd] = lm::from_f<T>(fmaf(dskip, xv, yv));
    }
  }
  __syncthreads();
  if (n_chunks > 0) store_y(n_chunks - 1);
  // the padded steps (dt = 0: a = 1, b = 0) left h as step S did
  if (h_last != nullptr && live) {
    float* hl = h_last + ((int64_t)b * Di + d) * N + n0;
#pragma unroll
    for (int j = 0; j < NPL; ++j) hl[j] = h[j];
  }
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* Bm, const void* Cm,
           const void* A_log, const void* D_skip, void* y, void* h_last,
           int B, int S, int Di, int bd, int chunk, cudaStream_t s) {
  auto kern = scan_kernel<T, N>;
  const int smem = (NSTG * 2 * chunk * (bd + N) + 2 * chunk * bd) *
                       (int)sizeof(T) +
                   4 * 4 * chunk * N;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Di + bd - 1) / bd), (unsigned)B);
  kern<<<grid, bd * LPS, smem, s>>>(
      (const T*)dt, (const T*)x, (const T*)Bm, (const T*)Cm,
      (const float*)A_log, (const float*)D_skip, (T*)y, (float*)h_last, S,
      Di, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int by_state(int N, const void* dt, const void* x, const void* Bm,
             const void* Cm, const void* A_log, const void* D_skip, void* y,
             void* h_last, int B, int S, int Di, int bd, int chunk,
             cudaStream_t s) {
  switch (N) {
    case 8: return launch<T, 8>(dt, x, Bm, Cm, A_log, D_skip, y, h_last, B,
                                S, Di, bd, chunk, s);
    case 16: return launch<T, 16>(dt, x, Bm, Cm, A_log, D_skip, y, h_last,
                                  B, S, Di, bd, chunk, s);
    case 32: return launch<T, 32>(dt, x, Bm, Cm, A_log, D_skip, y, h_last,
                                  B, S, Di, bd, chunk, s);
    case 64: return launch<T, 64>(dt, x, Bm, Cm, A_log, D_skip, y, h_last,
                                  B, S, Di, bd, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dt, x [B, S, Di]; Bm, Cm [B, S, N] in one dtype (0 = float32,
// 1 = bfloat16); A_log float32 [Di, N]; D_skip float32 [Di]; y [B, S, Di] in
// that dtype; h_last null or float32 [B, Di, N]. N is 8, 16, 32 or 64; S a
// multiple of chunk; Di a multiple of 16 bytes' elements; every pointer
// 16-byte aligned. bd channels a block, two lanes a channel: 2·bd a
// multiple of 32 and at most 256.
extern "C" int mamba_scan_launch(const void* dt, const void* x, const void* Bm,
                                 const void* Cm, const void* A_log,
                                 const void* D_skip, void* y, void* h_last,
                                 int dtype, int B, int S, int Di, int N,
                                 int bd, int chunk, void* stream) {
  if (B == 0 || S == 0 || Di == 0) return (int)cudaGetLastError();
  if (bd * LPS > MAX_THREADS || (bd * LPS) % 32 || chunk < 1 || S % chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == lm::DTYPE_F32)
    return by_state<float>(N, dt, x, Bm, Cm, A_log, D_skip, y, h_last, B, S,
                           Di, bd, chunk, s);
  if (dtype == lm::DTYPE_BF16)
    return by_state<__nv_bfloat16>(N, dt, x, Bm, Cm, A_log, D_skip, y,
                                   h_last, B, S, Di, bd, chunk, s);
  return (int)cudaErrorInvalidValue;
}
