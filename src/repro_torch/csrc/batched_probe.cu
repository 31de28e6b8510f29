// Batched read-set resolution: §5.2 directory probe + §5.1 version location.
//
// Replaces the TPU kernel src/repro/kernels/hash_probe/kernel.py:
// batched_probe (body _batched_kernel, with _dir_probe and
// _resolve_versions). The TPU launch stages the whole bucket array and all
// header planes in VMEM; a 2^24-bucket directory (128 MB) and 162 MB of
// header planes do not fit in an SM's 227 KB or in the 50 MB L2, so every
// lane works from device memory.
//
// Bound: a handful of random 32-byte sectors per lane, far below a
// microsecond of bytes; the time is latency. Walked one load at a time (one
// thread a lane), a lane's chain is probes + value + header + its ts_vec
// word + next_write + K (header, ts word) pairs + ovf_next + KO pairs of
// dependent DRAM trips. This design cuts the chain to about three trips:
//
//   0. the lane's own inputs; ts_vec is read through the read-only cache
//      (60 words on the main path: two sectors every lane shares);
//   1. a tile of kGroup threads serves one lane: a keyed lane loads a
//      window of kGroup consecutive buckets (keys and values, wrapping
//      modulo the bucket count) at once and takes the first bucket that
//      holds its key or is empty with a ballot, in the reference's order;
//      only a window with neither reads the next one (at most max_probes
//      buckets in all). A slot lane takes its fallback slot with JAX
//      gather semantics (wrap once, clamp);
//   2. the slot's independent loads go out together: the current header,
//      next_write, ovf_next, and the K old and KO overflow headers, which
//      are contiguous rows, one candidate a thread;
//   3. each thread ranks its usable candidate in resolve_versions' order
//      (current 0; old ring newest-first, skipping the never-written
//      sentinel, 1 + age; overflow newest-first, 1 + K + age) and a tile
//      min-reduction picks the newest usable version; with none, the
//      locator points at the newest overflow position.
//
// Reads are speculative (headers of versions that a sequential walk would
// not reach), which changes nothing: the kernel only reads, and every
// address stays in range (the slot is clamped first, ring positions are
// taken modulo K and KO). A version is usable iff cts <= T_R[min(tid,
// n-1)] and its deleted bit is clear. n_buckets == 0 skips the directory
// (locate-only).
#include <climits>
#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 16;     // threads that serve one lane
constexpr int kThreads = 256;  // 16 lanes a block

__global__ void __launch_bounds__(kThreads) batched_probe_kernel(
    const uint32_t* __restrict__ dir_keys, const int32_t* __restrict__ dir_vals,
    int64_t n_buckets, int max_probes,
    const uint2* __restrict__ cur_hdr, const uint2* __restrict__ old_hdr,
    const int32_t* __restrict__ next_write, const uint2* __restrict__ ovf_hdr,
    const int32_t* __restrict__ ovf_next, const uint32_t* __restrict__ ts_vec,
    int n_ts, int64_t n_rec, int k_old, int k_ovf,
    const int32_t* __restrict__ fallback, const uint32_t* __restrict__ keys,
    const uint8_t* __restrict__ key_mask, int64_t n_q,
    int32_t* __restrict__ o_slot, uint8_t* __restrict__ o_found,
    int32_t* __restrict__ o_src, int32_t* __restrict__ o_pos) {
  const cg::thread_block_tile<kGroup> tile =
      cg::tiled_partition<kGroup>(cg::this_thread_block());
  const int64_t q =
      (int64_t)blockIdx.x * (kThreads / kGroup) + tile.meta_group_rank();
  const int r = tile.thread_rank();

  // ---- 0. the lane's inputs ----------------------------------------------
  if (q >= n_q) return;
  const bool keyed = n_buckets > 0 && key_mask[q] != 0;
  const uint32_t key = keyed ? keys[q] : 0u;
  const int32_t fb = fallback[q];

  // ---- 1. slot: a window of the probe chain, or the fallback slot --------
  int32_t val = -1;
  bool got = false;
  int64_t slot;
  if (keyed) {
    const uint32_t key1 = key + 1u;  // keys are stored +1; 0 is empty
    const uint64_t base = (uint64_t)(key * 2654435769u) % (uint64_t)n_buckets;
    for (int p0 = 0; p0 < max_probes; p0 += kGroup) {
      const int p = p0 + r;
      uint32_t k = 1u;  // neither the key nor empty beyond max_probes
      int32_t v = -1;
      if (p < max_probes) {
        const uint64_t idx = (base + (uint64_t)p) % (uint64_t)n_buckets;
        k = dir_keys[idx];
        v = dir_vals[idx];
      }
      const unsigned stop = tile.ballot(p < max_probes &&
                                        (k == key1 || k == 0u));
      if (stop) {
        const int first = __ffs(stop) - 1;
        const uint32_t kf = tile.shfl(k, first);
        const int32_t vf = tile.shfl(v, first);
        if (kf == key1) {
          val = vf;
          got = vf >= 0;  // an entry with a value < 0 is invalidated
        }
        break;
      }
    }
    slot = got ? val : 0;
  } else {
    slot = fb < 0 ? (int64_t)fb + n_rec : (int64_t)fb;
    slot = slot < 0 ? 0 : (slot >= n_rec ? n_rec - 1 : slot);
  }
  if (slot >= n_rec) slot = n_rec - 1;  // a corrupt directory value

  // ---- 2./3. every candidate version at once, the newest usable wins -----
  const int nw = next_write[slot];
  const int on = ovf_next[slot];
  int best = INT_MAX;
  for (int c = r; c < 1 + k_old + k_ovf; c += kGroup) {
    uint2 h;
    int rank;
    bool ok = true;
    if (c == 0) {
      h = cur_hdr[slot];
      rank = 0;
    } else if (c <= k_old) {
      const int i = c - 1;
      h = old_hdr[slot * k_old + i];
      ok = !(h.y == 0u && (h.x >> probe::kThreadShift) == 0u &&
             (h.x & probe::kMoved) != 0u);  // the never-written sentinel
      rank = 1 + probe::ring_pos(nw, i, k_old);  // its age, newest 0
    } else {
      const int i = c - 1 - k_old;
      h = ovf_hdr[slot * k_ovf + i];
      rank = 1 + k_old + probe::ring_pos(on, i, k_ovf);
    }
    if (ok && rank < best && probe::usable(h, ts_vec, n_ts)) best = rank;
  }
  best = cg::reduce(tile, best, cg::less<int>());

  if (r == 0) {
    probe::Loc loc;
    if (best == 0)
      loc = {true, 0, 0};
    else if (best <= k_old)
      loc = {true, 1, probe::ring_pos(nw, best - 1, k_old)};
    else if (best != INT_MAX)
      loc = {true, 2, probe::ring_pos(on, best - 1 - k_old, k_ovf)};
    else
      loc = {false, 2, probe::ring_pos(on, 0, k_ovf)};
    o_slot[q] = keyed ? (got ? val : -1) : fb;
    o_found[q] = (!keyed || got) && loc.found;
    o_src[q] = loc.src;
    o_pos[q] = loc.pos;
  }
}

}  // namespace

extern "C" int batched_probe_launch(
    const void* dir_keys, const void* dir_vals, int64_t n_buckets,
    int max_probes, const void* cur_hdr, const void* old_hdr,
    const void* next_write, const void* ovf_hdr, const void* ovf_next,
    const void* ts_vec, int n_ts, int64_t n_rec, int k_old, int k_ovf,
    const void* fallback, const void* keys, const void* key_mask, int64_t n_q,
    void* o_slot, void* o_found, void* o_src, void* o_pos, void* stream) {
  if (n_q == 0) return (int)cudaGetLastError();
  constexpr int lanes = kThreads / kGroup;
  const unsigned blocks = (unsigned)((n_q + lanes - 1) / lanes);
  batched_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)dir_keys, (const int32_t*)dir_vals, n_buckets,
      max_probes, (const uint2*)cur_hdr, (const uint2*)old_hdr,
      (const int32_t*)next_write, (const uint2*)ovf_hdr,
      (const int32_t*)ovf_next, (const uint32_t*)ts_vec, n_ts, n_rec, k_old,
      k_ovf, (const int32_t*)fallback, (const uint32_t*)keys,
      (const uint8_t*)key_mask, n_q, (int32_t*)o_slot, (uint8_t*)o_found,
      (int32_t*)o_src, (int32_t*)o_pos);
  return (int)cudaGetLastError();
}
