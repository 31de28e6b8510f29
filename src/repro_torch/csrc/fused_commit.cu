// Write side of one SI round: validate + CAS-lock, install-feasibility,
// per-transaction commit decision, install (headers and payloads),
// make-visible (§3.1 Listing 1).
//
// Replaces the TPU kernel src/repro/kernels/commit/kernel.py:fused_commit
// (body _commit_kernel). That launch is one grid step with every header
// plane resident in VMEM; here the planes (54 MB of current headers alone
// at 6.7 M records) stay in global memory and the round's Q requests are
// spread over threads.
//
// Bound: a few random 32-byte sectors per request (its header, ring
// counter, ring victim, payload row, and the installs' writes) — about
// 10^3 requests, so well under a microsecond of bytes. What costs is
// latency: the launch, the barriers the decide/apply contract needs
// between its phases, and a few dependent DRAM trips per phase.
//
// Design: ONE launch of ONE thread-block cluster (kBlocks blocks, the
// portable maximum, on neighbouring SMs). The grid-wide barriers between
// the phases are Hopper's cluster barrier (barrier.cluster, release and
// acquire at cluster scope), so a round takes one launch: each block owns
// a contiguous share of the requests and of the transactions, and loops
// over it when the share is wider than the block. A block keeps
// kLaneBytes (25) for each request of its share in shared memory; when the
// share does not fit there (above 74,376 requests a launch) the wrapper
// passes a global scratch and every block keeps its share there instead.
//
//   1. bid:    atomicMin(arb[s].bid, prio) at the scattered slot s;
//              fails[t] = 0. The request's slot, priority, txn id and
//              active flag go to the lane state, as later do the header,
//              ring position and outcome of the grant phase: after a
//              cluster barrier a reload from global memory is an L2 trip,
//              a shared-memory read is not;
//   2. grant:  won ⇔ arb[g].bid == prio at the gathered slot g;
//              granted ⇔ won ∧ the 8-byte header at g matches ∧ unlocked;
//              effective ⇔ granted ∧ the ring victim at next_write mod K
//              is moved; atomicAdd(fails[t], 1) for every active request
//              that is not effective. The header, ring position and payload
//              row read at g are kept for every active request, before any
//              install moves them;
//   3. decide: every bid is reset (no won test is left to read it);
//              do_install ⇔ effective ∧ the transaction commits
//              (fails + ext_fails == 0 ∧ txn_ok); atomicMax(arb[s].vote,
//              q+1) elects the highest installing request of each slot;
//              per transaction committed and atomicMax(vec[slot], cts or 0);
//   4. apply:  each installing request moves the kept version into the
//              ring victim (header with lock and moved clear, payload row)
//              and advances next_write; the elected one writes the new
//              current header (lock clear) and payload row, and resets the
//              vote.
//
// The tournament is a global slot-keyed table arb[R] of two 32-bit words
// (bid, vote), kept by the wrapper for each stream and record count. Every
// entry is (kNoWinner, 0) between launches: a launch touches only the
// round's in-range slots and resets each of them after its last read (the
// bids in phase 3; a vote when the elected request reads it — any other
// request of the slot then reads either the winner's q+1 or 0, never its
// own). So nothing carries over from one launch to the next, and no reset
// pass or epoch is needed; a replayed launch finds the table as the first
// one did. Two launches must not share a table at once, hence one table per
// stream. A hash table in distributed shared memory would spend about 2Q
// entries of the cluster's shared memory beside the lane state and need a
// rule for a full table. The election needs its own barrier (a
// transaction's decision is known only after the grant phase), so the
// phases are four with three barriers (kBarriers).
//
// Decide-only launch (a memory server's part of a cross-server decision,
// store.distributed_round): phases 1 and 2, then every bid is reset after
// a second barrier and the launch ends. Its one output is fails; it writes
// no header, ring, payload, next_write, vote, vec, granted, committed or
// do_install, and reads no payload row. The server's apply launch that
// follows replays the same tournament with ext_fails = total - local.
//
// Index rule (JAX's): a gather wraps a negative slot once and then clamps
// it (g); a scatter wraps once and DROPS what is still out of range (s).
// So a request out of range bids nothing, yet its won test reads the
// clamped slot, where a request of the same priority may have won: it is
// then granted and can commit its transaction while writing nothing.
//
// Two requests of one priority on one slot (one transaction writing a
// record twice, or two transactions of one priority) both win; both move
// the same kept version to the same ring position and both advance
// next_write, and the highest lane's version becomes current — what the
// reference's in-order scatter gives and the plain version states.
// Lock-set and release cancel inside the round, so a granted request of an
// aborted transaction writes nothing (the net transition). Integer atomics
// and the election make every result independent of thread order: the
// outputs are bit-exact.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kLocked = 1u << 0;
constexpr uint32_t kMoved = 1u << 2;
constexpr uint32_t kNoWinner = 0xFFFFFFFFu;
constexpr int kBlocks = 8;     // one cluster of the portable maximum size
constexpr int kThreads = 256;
constexpr int kBarriers = 3;   // the cluster barriers fused_commit_kernel
                               // passes, one between each two phases

struct Args {
  uint2* cur_hdr;
  int32_t* cur_data;
  uint2* old_hdr;
  int32_t* old_data;
  int32_t* next_write;
  uint32_t* vec;
  int n_vec;
  int64_t n_rec;
  int k_old;
  int width;
  const int32_t* slots;
  const uint2* expected;
  const uint32_t* prio;
  const uint8_t* act;
  const int32_t* txn;
  const uint2* new_hdr;
  const int32_t* new_data;
  int64_t n_q;
  const uint8_t* txn_ok;
  const int32_t* txn_slot;
  const uint32_t* cts;
  const int32_t* ext_fails;
  int n_txn;
  int decide_only;   // phases 1-2 and the bid reset only (see above)
  // scratch: per request the payload row read in the grant phase, and
  // the lane state when it does not fit in shared memory (else null)
  int32_t* kept_data;
  unsigned char* lane_scratch;
  // outputs
  uint8_t* granted;
  uint8_t* committed;
  uint8_t* do_install;
  int32_t* fails;
  // the arbitration table, [R] of (bid, vote), (kNoWinner, 0) on entry
  // and on exit
  uint2* arb;
};

// gather: a negative index wraps once, then clamps into [0, n)
__device__ __forceinline__ int64_t gather_idx(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// scatter: a negative index wraps once; -1 (dropped) if still out of range
__device__ __forceinline__ int64_t scatter_idx(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return i >= 0 && i < n ? i : -1;
}

// this block's contiguous share [base, end) of n lanes; its threads take
// lanes base + threadIdx.x, then every blockDim.x-th
struct Share {
  int64_t base, end;
};
__device__ __forceinline__ Share share(int64_t n) {
  const int64_t per = (n + gridDim.x - 1) / gridDim.x;
  const int64_t b = (int64_t)blockIdx.x * per;
  return {b, b + per < n ? b + per : n};
}

// What the phases pass on for each request of the block's share
// (kLaneBytes a request), so that no phase reloads it: the inputs the
// later phases read, and what the grant phase decides. A block's lane
// state starts at a multiple of 16 bytes (the shared memory, or its stride
// of the global scratch)
constexpr uint8_t kActive = 1, kEffective = 2, kInstall = 4;
constexpr int kLaneBytes = 8 + 4 * 4 + 1;
struct Lanes {
  uint2* hdr;       // the header read at the gathered slot
  int32_t* slot;
  uint32_t* prio;
  int32_t* txn;
  int32_t* pos;     // the ring position read there
  uint8_t* flags;
};
__host__ __device__ __forceinline__ int64_t lane_stride(int64_t n_q) {
  return ((n_q + kBlocks - 1) / kBlocks * kLaneBytes + 15) / 16 * 16;
}
__device__ __forceinline__ Lanes lanes(unsigned char* base, int64_t n) {
  Lanes l;
  l.hdr = (uint2*)base;
  l.slot = (int32_t*)(l.hdr + n);
  l.prio = (uint32_t*)(l.slot + n);
  l.txn = (int32_t*)(l.prio + n);
  l.pos = (int32_t*)(l.txn + n);
  l.flags = (uint8_t*)(l.pos + n);
  return l;
}

// a payload row of w words, 8 loads in flight before their stores
__device__ __forceinline__ void copy_row(int32_t* dst, const int32_t* src,
                                         int w) {
  constexpr int kChunk = 8;
  for (int b = 0; b < w; b += kChunk) {
    int32_t v[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (b + i < w) v[i] = src[b + i];
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (b + i < w) dst[b + i] = v[i];
  }
}

__global__ void __launch_bounds__(kThreads) fused_commit_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Share rq = share(a.n_q), tx = share(a.n_txn);
  const Lanes l = lanes(
      a.lane_scratch ? a.lane_scratch + blockIdx.x * lane_stride(a.n_q) : smem,
      (a.n_q + gridDim.x - 1) / gridDim.x);
  const int64_t R = a.n_rec;
  const int K = a.k_old, W = a.width;

  // ---- 1. bid -------------------------------------------------------------
  for (int64_t i = threadIdx.x; rq.base + i < rq.end; i += blockDim.x) {
    const int64_t q = rq.base + i;
    const bool act = a.act[q] != 0;
    const int32_t slot = a.slots[q];
    const uint32_t p = a.prio[q];
    l.slot[i] = slot;
    l.prio[i] = p;
    l.txn[i] = a.txn[q];
    l.flags[i] = act ? kActive : 0;
    const int64_t s = scatter_idx(slot, R);
    if (act && s >= 0) atomicMin(&a.arb[s].x, p);
  }
  for (int64_t t = tx.base + threadIdx.x; t < tx.end; t += blockDim.x)
    a.fails[t] = 0;
  cluster.sync();

  // ---- 2. grant -----------------------------------------------------------
  for (int64_t i = threadIdx.x; rq.base + i < rq.end; i += blockDim.x) {
    const int64_t q = rq.base + i;
    bool g = false;
    if (l.flags[i] & kActive) {
      const int64_t s = gather_idx(l.slot[i], R);
      const uint32_t p = l.prio[i];
      const uint2 exp = a.expected[q];
      const uint2 inst = a.cur_hdr[s];
      int w = a.next_write[s] % K;  // jnp.mod: the result takes K's sign
      if (w < 0) w += K;
      const bool won = p != kNoWinner && __ldcg(&a.arb[s].x) == p;
      // kept whatever the outcome, so that these loads need not wait for it
      l.hdr[i] = inst;
      l.pos[i] = w;
      if (!a.decide_only)
        copy_row(a.kept_data + q * W, a.cur_data + s * W, W);
      g = won && inst.x == exp.x && inst.y == exp.y &&
          (inst.x & kLocked) == 0u;
      const bool eff = g && (a.old_hdr[s * K + w].x & kMoved) != 0u;
      const int64_t t = scatter_idx(l.txn[i], a.n_txn);
      if (!eff && t >= 0) atomicAdd(&a.fails[t], 1);
      if (eff) l.flags[i] |= kEffective;
    }
    if (!a.decide_only) a.granted[q] = g;
  }
  cluster.sync();

  if (a.decide_only) {   // uniform over the cluster: no barrier is skipped
    for (int64_t i = threadIdx.x; rq.base + i < rq.end; i += blockDim.x) {
      const int64_t s = scatter_idx(l.slot[i], R);
      if ((l.flags[i] & kActive) && s >= 0) a.arb[s].x = kNoWinner;
    }
    return;
  }

  // ---- 3. decide ----------------------------------------------------------
  for (int64_t i = threadIdx.x; rq.base + i < rq.end; i += blockDim.x) {
    // padding lanes may carry any txn id: only an effective (hence active)
    // lane reads its transaction's decision
    bool d = false;
    const int64_t s = scatter_idx(l.slot[i], R);
    if ((l.flags[i] & kActive) && s >= 0) a.arb[s].x = kNoWinner;
    if ((l.flags[i] & kEffective) && a.n_txn > 0) {
      const int64_t t = gather_idx(l.txn[i], a.n_txn);
      d = __ldcg(&a.fails[t]) + a.ext_fails[t] == 0 && a.txn_ok[t];
      if (d && s >= 0) atomicMax(&a.arb[s].y, (uint32_t)(rq.base + i + 1));
      if (d) l.flags[i] |= kInstall;
    }
    a.do_install[rq.base + i] = d;
  }
  for (int64_t t = tx.base + threadIdx.x; t < tx.end; t += blockDim.x) {
    const bool c = __ldcg(&a.fails[t]) + a.ext_fails[t] == 0 && a.txn_ok[t];
    a.committed[t] = c;
    const int64_t v = scatter_idx(a.txn_slot[t], a.n_vec);
    if (v >= 0) atomicMax(&a.vec[v], c ? a.cts[t] : 0u);
  }
  cluster.sync();

  // ---- 4. apply -----------------------------------------------------------
  for (int64_t i = threadIdx.x; rq.base + i < rq.end; i += blockDim.x) {
    const int64_t q = rq.base + i;
    const int64_t s = scatter_idx(l.slot[i], R);
    if (!(l.flags[i] & kInstall) || s < 0) continue;
    const uint2 prev = l.hdr[i];
    const int64_t o = s * K + l.pos[i];
    a.old_hdr[o] = make_uint2(prev.x & ~kLocked & ~kMoved, prev.y);
    copy_row(a.old_data + o * W, a.kept_data + q * W, W);
    atomicAdd(&a.next_write[s], 1);
    if (__ldcg(&a.arb[s].y) == (uint32_t)(q + 1)) {
      a.arb[s].y = 0u;
      const uint2 nh = a.new_hdr[q];
      a.cur_hdr[s] = make_uint2(nh.x & ~kLocked, nh.y);
      copy_row(a.cur_data + s * W, a.new_data + q * W, W);
    }
  }
}

// the launch floor: nothing, or only the commit kernel's cluster barriers
// (none, or kBarriers), in its cluster shape
__global__ void empty_kernel() {}

__global__ void __launch_bounds__(kThreads) barrier_kernel(int n_sync) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < n_sync; ++i) cluster.sync();
}

// the launch of one cluster of kBlocks blocks of kThreads threads
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  explicit ClusterLaunch(void* stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kBlocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kBlocks);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

int launch_error(cudaError_t err) {
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" int fused_commit_launch(
    void* cur_hdr, void* cur_data, void* old_hdr, void* old_data,
    void* next_write, void* vec, int n_vec, int64_t n_rec, int k_old,
    int width, const void* slots, const void* expected, const void* prio,
    const void* act, const void* txn, const void* new_hdr,
    const void* new_data, int64_t n_q, const void* txn_ok,
    const void* txn_slot, const void* cts, const void* ext_fails, int n_txn,
    int decide_only, void* kept_data, void* lane_scratch, void* granted,
    void* committed, void* do_install, void* fails, void* arb, void* stream) {
  if (n_q == 0 && n_txn == 0) return (int)cudaGetLastError();
  const Args a{(uint2*)cur_hdr, (int32_t*)cur_data, (uint2*)old_hdr,
               (int32_t*)old_data, (int32_t*)next_write, (uint32_t*)vec,
               n_vec, n_rec, k_old, width, (const int32_t*)slots,
               (const uint2*)expected, (const uint32_t*)prio,
               (const uint8_t*)act, (const int32_t*)txn,
               (const uint2*)new_hdr, (const int32_t*)new_data, n_q,
               (const uint8_t*)txn_ok, (const int32_t*)txn_slot,
               (const uint32_t*)cts, (const int32_t*)ext_fails, n_txn,
               decide_only, (int32_t*)kept_data,
               (unsigned char*)lane_scratch,
               (uint8_t*)granted, (uint8_t*)committed, (uint8_t*)do_install,
               (int32_t*)fails, (uint2*)arb};
  ClusterLaunch l(stream);
  // the lane state: the block's shared memory, or its stride of the scratch
  l.cfg.dynamicSmemBytes = lane_scratch ? 0 : (size_t)lane_stride(n_q);
  if (l.cfg.dynamicSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)l.cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_error(cudaLaunchKernelEx(&l.cfg, fused_commit_kernel, a));
}

// The cluster barriers the commit kernel passes.
extern "C" int fused_commit_barriers() { return kBarriers; }

// The launch floor of this design, for measurement: barriers < 0 launches
// an empty kernel of one 32-thread block; 0 launches one cluster of the
// commit kernel's shape that does nothing; 1 one that passes the kernel's
// kBarriers cluster barriers and nothing else.
extern "C" int fused_commit_floor_launch(int barriers, void* stream) {
  if (barriers < 0) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
  }
  ClusterLaunch l(stream);
  return launch_error(cudaLaunchKernelEx(&l.cfg, barrier_kernel,
                                         barriers ? kBarriers : 0));
}
