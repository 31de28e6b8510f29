// Write side of one SI round: validate + CAS-lock, install-feasibility,
// per-transaction commit decision, install, make-visible (§3.1 Listing 1).
//
// Replaces the TPU kernel src/repro/kernels/commit/kernel.py:fused_commit
// (body _commit_kernel). That launch is one grid step with every header
// plane resident in VMEM; here the planes (54 MB of current headers alone
// at 6.7 M records) stay in global memory and the round's Q requests are
// spread over threads. The decide/apply contract needs a grid-wide barrier
// twice (after the tournament, after the failure counts), so the work is
// four short launches on one stream:
//
//   1. reset:  arb[safe[q]] = NO_WINNER for the touched slots only, and
//              fails[t] = 0 — never a memset of an R-sized array;
//   2. bid:    atomicMin(arb[safe[q]], prio[q]) for active requests;
//   3. grant:  won ∧ 8-byte match ∧ unlocked; the ring victim at
//              next_write mod K must be moved; atomicAdd(fails[txn], 1)
//              for every active request that is not effective. The
//              installed header and wpos are kept per request;
//   4. apply:  committed ⇔ fails + ext_fails == 0 ∧ txn_ok; a granted
//              request of a committed transaction installs: current ←
//              new (lock clear), ring victim ← old current (lock and moved
//              clear), atomicAdd(next_write, 1); per transaction
//              atomicMax(vec[txn_slot], committed ? cts : 0).
//
// Lock-set and release cancel inside the round, so a granted request of an
// aborted transaction writes nothing (the net transition). Integer atomics
// make every result independent of thread order: the outputs are
// bit-exact. Phase 4 reads only what phase 3 saved, so two requests of one
// transaction on one slot write identical values. Payloads never enter the
// kernel; the wrapper scatters them on the do_install mask.
//
// Bound: random 32-byte sectors of the touched headers, ring victims and
// counters (a few per request) plus the launch latency of four launches;
// Q is ~10^3, so the launches dominate. The design touches only the
// request's own slots in every phase.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLocked = 1u << 0;
constexpr uint32_t kMoved = 1u << 2;
constexpr uint32_t kNoWinner = 0xFFFFFFFFu;

// JAX gather semantics for an index: negative wraps once, then clamp
__device__ __forceinline__ int64_t jidx(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int64_t safe_slot(const int32_t* slots,
                                             const uint8_t* act, int64_t q,
                                             int64_t n_rec) {
  return act[q] ? jidx(slots[q], n_rec) : 0;
}

__global__ void reset_kernel(const int32_t* __restrict__ slots,
                             const uint8_t* __restrict__ act, int64_t n_q,
                             int64_t n_rec, uint32_t* __restrict__ arb,
                             int32_t* __restrict__ fails, int n_txn) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_q) arb[safe_slot(slots, act, i, n_rec)] = kNoWinner;
  if (i < n_txn) fails[i] = 0;
}

__global__ void bid_kernel(const int32_t* __restrict__ slots,
                           const uint8_t* __restrict__ act,
                           const uint32_t* __restrict__ prio, int64_t n_q,
                           int64_t n_rec, uint32_t* __restrict__ arb) {
  int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q < n_q && act[q]) atomicMin(&arb[jidx(slots[q], n_rec)], prio[q]);
}

__global__ void grant_kernel(
    const uint2* __restrict__ cur_hdr, const uint2* __restrict__ old_hdr,
    const int32_t* __restrict__ next_write, int64_t n_rec, int k_old,
    const int32_t* __restrict__ slots, const uint2* __restrict__ expected,
    const uint32_t* __restrict__ prio, const uint8_t* __restrict__ act,
    const int32_t* __restrict__ txn, int64_t n_q, int n_txn,
    const uint32_t* __restrict__ arb, uint8_t* __restrict__ granted,
    uint8_t* __restrict__ effective, uint2* __restrict__ installed,
    int32_t* __restrict__ wpos, int32_t* __restrict__ fails) {
  int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_q) return;
  const bool a = act[q] != 0;
  const int64_t s = safe_slot(slots, act, q, n_rec);
  const uint32_t mprio = a ? prio[q] : kNoWinner;
  const bool won = a && arb[s] == mprio && mprio != kNoWinner;
  const uint2 inst = cur_hdr[s];
  const uint2 exp = expected[q];
  const bool g = won && inst.x == exp.x && inst.y == exp.y &&
                 (inst.x & kLocked) == 0u;
  int w = next_write[s] % k_old;  // jnp.mod: the result takes k's sign
  if (w < 0) w += k_old;
  const bool eff = g && (old_hdr[s * k_old + w].x & kMoved) != 0u;
  granted[q] = g;
  effective[q] = eff;
  installed[q] = inst;
  wpos[q] = w;
  // a scatter drops an index that is out of range once negatives wrap
  int64_t t = txn[q];
  if (t < 0) t += n_txn;
  if (a && !eff && t >= 0 && t < n_txn) atomicAdd(&fails[t], 1);
}

__global__ void apply_kernel(
    uint2* __restrict__ cur_hdr, uint2* __restrict__ old_hdr,
    int32_t* __restrict__ next_write, uint32_t* __restrict__ vec, int n_vec,
    int64_t n_rec, int k_old, const int32_t* __restrict__ slots,
    const uint8_t* __restrict__ act, const int32_t* __restrict__ txn,
    const uint2* __restrict__ new_hdr, int64_t n_q,
    const uint8_t* __restrict__ txn_ok, const int32_t* __restrict__ txn_slot,
    const uint32_t* __restrict__ cts, const int32_t* __restrict__ ext_fails,
    int n_txn, const int32_t* __restrict__ fails,
    const uint8_t* __restrict__ effective, const uint2* __restrict__ installed,
    const int32_t* __restrict__ wpos, uint8_t* __restrict__ committed,
    uint8_t* __restrict__ do_install) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_q) {
    // padding lanes may carry any txn id: only an effective (hence active)
    // lane reads its transaction's decision
    bool inst = false;
    if (effective[i]) {
      const int64_t t = jidx(txn[i], n_txn);
      inst = fails[t] + ext_fails[t] == 0 && txn_ok[t];
    }
    do_install[i] = inst;
    if (inst) {
      const int64_t s = safe_slot(slots, act, i, n_rec);
      const uint2 prev = installed[i];
      const uint2 nh = new_hdr[i];
      cur_hdr[s] = make_uint2(nh.x & ~kLocked, nh.y);
      old_hdr[s * k_old + wpos[i]] =
          make_uint2(prev.x & ~kLocked & ~kMoved, prev.y);
      atomicAdd(&next_write[s], 1);
    }
  }
  if (i < n_txn) {
    const bool c = fails[i] + ext_fails[i] == 0 && txn_ok[i];
    committed[i] = c;
    int64_t v = txn_slot[i];
    if (v < 0) v += n_vec;
    if (v >= 0 && v < n_vec) atomicMax(&vec[v], c ? cts[i] : 0u);
  }
}

}  // namespace

extern "C" int fused_commit_launch(
    void* cur_hdr, void* old_hdr, void* next_write, void* vec, int n_vec,
    int64_t n_rec, int k_old, const void* slots, const void* expected,
    const void* prio, const void* act, const void* txn, const void* new_hdr,
    int64_t n_q, const void* txn_ok, const void* txn_slot, const void* cts,
    const void* ext_fails, int n_txn, void* arb, void* installed, void* wpos,
    void* effective, void* granted, void* committed, void* do_install,
    void* fails, void* stream) {
  const int threads = 128;
  const int64_t n = n_q > n_txn ? n_q : n_txn;
  if (n == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* s = (const int32_t*)slots;
  const uint8_t* a = (const uint8_t*)act;
  reset_kernel<<<blocks, threads, 0, st>>>(s, a, n_q, n_rec, (uint32_t*)arb,
                                           (int32_t*)fails, n_txn);
  bid_kernel<<<blocks, threads, 0, st>>>(s, a, (const uint32_t*)prio, n_q,
                                         n_rec, (uint32_t*)arb);
  grant_kernel<<<blocks, threads, 0, st>>>(
      (const uint2*)cur_hdr, (const uint2*)old_hdr,
      (const int32_t*)next_write, n_rec, k_old, s, (const uint2*)expected,
      (const uint32_t*)prio, a, (const int32_t*)txn, n_q, n_txn,
      (const uint32_t*)arb, (uint8_t*)granted, (uint8_t*)effective,
      (uint2*)installed, (int32_t*)wpos, (int32_t*)fails);
  apply_kernel<<<blocks, threads, 0, st>>>(
      (uint2*)cur_hdr, (uint2*)old_hdr, (int32_t*)next_write, (uint32_t*)vec,
      n_vec, n_rec, k_old, s, a, (const int32_t*)txn,
      (const uint2*)new_hdr, n_q, (const uint8_t*)txn_ok,
      (const int32_t*)txn_slot, (const uint32_t*)cts,
      (const int32_t*)ext_fails, n_txn, (const int32_t*)fails,
      (const uint8_t*)effective, (const uint2*)installed,
      (const int32_t*)wpos, (uint8_t*)committed, (uint8_t*)do_install);
  return (int)cudaGetLastError();
}
