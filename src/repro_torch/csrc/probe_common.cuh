// Device code of the probe kernels (batched_probe.cu, hash_probe.cu): the
// usability test, ring positions and header bits, and the tile versions of
// _dir_probe and _resolve_versions of src/repro/kernels/hash_probe/kernel.py.
// A tile of kGroup threads serves one lane in both kernels.
//
// Bound: a handful of random 32-byte sectors per lane, far below a
// microsecond of bytes; the time is latency. Walked one load at a time (one
// thread a lane), a lane's chain is probes + value + header + its ts_vec
// word + next_write + K (header, ts word) pairs + ovf_next + KO pairs of
// dependent DRAM trips. The tile cuts it to a window, a header and its ts
// word when the current version serves the read, and two trips more when
// it does not; speculative ring loads (the first tile design, PR 16) cost
// more bytes than the trips they saved when the current version serves:
//
//   1. tile_dir_probe: the tile loads a window of kGroup consecutive
//      buckets (keys and values, wrapping modulo the bucket count) at once
//      and takes the first bucket that holds the key or is empty with a
//      ballot, in probe order; the hit test comes first, so the key
//      0xFFFFFFFF (stored as 0, like an empty bucket) hits the first empty
//      bucket, as in the reference. Lanes at probe distance >= max_probes
//      do not vote (the last window may be partial; with fewer buckets than
//      kGroup the window wraps onto itself and the first vote in probe
//      order wins). Only a window with neither reads the next one;
//   2. tile_resolve: the current header and its ts_vec word, which serve
//      nearly every read (then nothing else is loaded);
//   3. otherwise the ring's independent loads go out together: next_write,
//      ovf_next and the K old and KO overflow headers, which are contiguous
//      rows, a few candidates a thread, all loaded before any is tested;
//      each thread ranks its usable candidates in the reference's order
//      (old ring newest-first, skipping the never-written sentinel, 1 +
//      age; overflow newest-first, 1 + K + age) and a tile min-reduction
//      picks the newest usable version; with none, the locator points at
//      the newest overflow position.
//
// Reads are speculative (headers that a sequential walk would not reach),
// which changes nothing: the kernels only read, and every address stays in
// range (the caller clamps the slot, ring positions are taken modulo K and
// KO). A version is usable iff cts <= T_R[min(tid, n-1)] and its deleted
// bit is clear.
#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace probe {

namespace cg = cooperative_groups;

constexpr uint32_t kDeleted = 1u << 1;
constexpr uint32_t kMoved = 1u << 2;
constexpr int kThreadShift = 3;
constexpr int kGroup = 16;     // threads that serve one lane
constexpr int kThreads = 256;  // 16 lanes a block

using Tile = cg::thread_block_tile<kGroup>;

// ts (global memory, read-only during a launch) is read through the
// read-only cache.
__device__ __forceinline__ bool usable(uint2 h, const uint32_t* ts, int n_ts) {
  uint32_t tid = h.x >> kThreadShift;
  uint32_t t =
      __ldg(&ts[tid < (uint32_t)(n_ts - 1) ? tid : (uint32_t)(n_ts - 1)]);
  return h.y <= t && (h.x & kDeleted) == 0;
}

__device__ __forceinline__ int ring_pos(int next, int age, int k) {
  int p = (next - 1 - age) % k;  // jnp.mod: the result takes k's sign
  return p < 0 ? p + k : p;
}

// Linear probe for ``key`` (keys are stored +1; 0 is empty) over at most
// max_probes buckets, a window of kGroup at a time. ``*val`` is the hit
// bucket's value, -1 when the key is absent; an entry with a value < 0 is
// invalidated. Returns whether the key was found with a valid value. Every
// thread of the tile returns the same. Bucket arithmetic is 32-bit (the
// reference's uint32 hash modulo the bucket count; callers keep the count
// below 2^32).
__device__ __forceinline__ bool tile_dir_probe(
    const Tile& tile, const uint32_t* __restrict__ dir_keys,
    const int32_t* __restrict__ dir_vals, uint32_t n_buckets, int max_probes,
    uint32_t key, int32_t* val) {
  const int r = tile.thread_rank();
  const uint32_t key1 = key + 1u;
  const uint32_t base = (key * 2654435769u) % n_buckets;
  *val = -1;
  for (int p0 = 0; p0 < max_probes; p0 += kGroup) {
    const uint32_t p = (uint32_t)(p0 + r);
    uint32_t k = 1u;  // neither the key nor empty beyond max_probes
    int32_t v = -1;
    if (p < (uint32_t)max_probes) {
      uint32_t idx = base + (p < n_buckets ? p : p % n_buckets);
      if (idx >= n_buckets) idx -= n_buckets;
      k = dir_keys[idx];
      v = dir_vals[idx];
    }
    const unsigned stop =
        tile.ballot(p < (uint32_t)max_probes && (k == key1 || k == 0u));
    if (stop) {
      const int first = __ffs(stop) - 1;
      const uint32_t kf = tile.shfl(k, first);
      const int32_t vf = tile.shfl(v, first);
      if (kf == key1) *val = vf;
      return kf == key1 && vf >= 0;
    }
  }
  return false;
}

struct Loc {
  bool found;
  int src;  // 0 current, 1 old ring, 2 overflow ring
  int pos;
};

constexpr int kPerThread = 4;  // ring headers a thread loads at once

// §5.1 location of the newest usable version of an in-range ``slot``. The
// current version first (one header, one ts_vec word): it serves nearly
// every read, and then no ring header is loaded. Otherwise every ring
// header at once (old ring newest-first, skipping the never-written
// sentinel: cts 0, thread 0, moved; then the overflow ring), each thread
// issuing its loads before it tests any, and a tile min-reduction of the
// usable candidates' ranks. Every thread of the tile returns the same.
__device__ __forceinline__ Loc tile_resolve(
    const Tile& tile, int64_t slot, const uint2* __restrict__ cur_hdr,
    const uint2* __restrict__ old_hdr, const int32_t* __restrict__ next_write,
    const uint2* __restrict__ ovf_hdr, const int32_t* __restrict__ ovf_next,
    const uint32_t* __restrict__ ts_vec, int n_ts, int k_old, int k_ovf) {
  const int r = tile.thread_rank();
  bool cur_ok = false;
  if (r == 0) cur_ok = usable(cur_hdr[slot], ts_vec, n_ts);
  if (tile.shfl(cur_ok, 0)) return {true, 0, 0};

  const int n_ring = k_old + k_ovf;
  const int nw = next_write[slot];
  const int on = ovf_next[slot];
  int best = INT_MAX;
  for (int c0 = 0; c0 < n_ring; c0 += kGroup * kPerThread) {
    uint2 h[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = c0 + i * kGroup + r;
      if (c < k_old)
        h[i] = old_hdr[slot * k_old + c];
      else if (c < n_ring)
        h[i] = ovf_hdr[slot * k_ovf + (c - k_old)];
    }
    bool ok[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {  // every ts_vec word at once
      const int c = c0 + i * kGroup + r;
      ok[i] = c < n_ring && usable(h[i], ts_vec, n_ts);
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = c0 + i * kGroup + r;
      if (!ok[i]) continue;
      int rank;
      if (c < k_old) {
        if (h[i].y == 0u && (h[i].x >> kThreadShift) == 0u &&
            (h[i].x & kMoved) != 0u)
          continue;  // the never-written sentinel
        rank = 1 + ring_pos(nw, c, k_old);  // its age, newest 0
      } else {
        rank = 1 + k_old + ring_pos(on, c - k_old, k_ovf);
      }
      best = rank < best ? rank : best;
    }
  }
  best = cg::reduce(tile, best, cg::less<int>());
  if (best <= k_old) return {true, 1, ring_pos(nw, best - 1, k_old)};
  if (best != INT_MAX)
    return {true, 2, ring_pos(on, best - 1 - k_old, k_ovf)};
  return {false, 2, ring_pos(on, 0, k_ovf)};
}

}  // namespace probe
