// Device code of the probe kernels: the usability test, ring positions and
// header bits both use (batched_probe.cu, hash_probe.cu), and
// hash_probe.cu's one-thread §5.2 directory walk and §5.1 version location,
// which mirror _dir_probe and _resolve_versions of
// src/repro/kernels/hash_probe/kernel.py (batched_probe.cu runs both steps
// with a tile of threads).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace probe {

constexpr uint32_t kDeleted = 1u << 1;
constexpr uint32_t kMoved = 1u << 2;
constexpr int kThreadShift = 3;

// A version is usable iff cts <= T_R[min(tid, n-1)] and it is not deleted.
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

// Linear-probe walk for ``key`` (keys are stored +1; 0 is empty): at most
// max_probes buckets, stopping at the key or an empty bucket. ``val`` is the
// hit bucket's value, -1 when the key is absent; an entry with val < 0 is
// invalidated. Returns whether the key was found with a valid value.
__device__ __forceinline__ bool dir_probe(const uint32_t* __restrict__ dir_keys,
                                          const int32_t* __restrict__ dir_vals,
                                          int64_t n_buckets, int max_probes,
                                          uint32_t key, int32_t* val) {
  const uint32_t key1 = key + 1u;
  const uint64_t base = (uint64_t)(key * 2654435769u) % (uint64_t)n_buckets;
  *val = -1;
  for (int p = 0; p < max_probes; ++p) {
    const uint64_t idx = (base + (uint64_t)p) % (uint64_t)n_buckets;
    const uint32_t k = dir_keys[idx];
    if (k == key1) {
      *val = dir_vals[idx];
      return *val >= 0;
    }
    if (k == 0u) break;
  }
  return false;
}

struct Loc {
  bool found;
  int src;  // 0 current, 1 old ring, 2 overflow ring
  int pos;
};

// §5.1 location of the newest usable version of an in-range ``slot``:
// current header, old ring newest-first (skipping the never-written
// sentinel: cts 0, thread 0, moved), then the overflow ring. Each region is
// scanned only when the earlier ones did not serve the read; when nothing
// does, the locator points at the newest overflow position.
__device__ __forceinline__ Loc resolve_versions(
    int64_t slot, const uint2* __restrict__ cur_hdr,
    const uint2* __restrict__ old_hdr, const int32_t* __restrict__ next_write,
    const uint2* __restrict__ ovf_hdr, const int32_t* __restrict__ ovf_next,
    const uint32_t* __restrict__ ts_vec, int n_ts, int k_old, int k_ovf) {
  if (usable(cur_hdr[slot], ts_vec, n_ts)) return {true, 0, 0};
  const int nw = next_write[slot];
  for (int a = 0; a < k_old; ++a) {
    const int p = ring_pos(nw, a, k_old);
    const uint2 h = old_hdr[slot * k_old + p];
    const bool sentinel = h.y == 0u && (h.x >> kThreadShift) == 0u &&
                          (h.x & kMoved) != 0u;
    if (!sentinel && usable(h, ts_vec, n_ts)) return {true, 1, p};
  }
  const int on = ovf_next[slot];
  for (int a = 0; a < k_ovf; ++a) {
    const int p = ring_pos(on, a, k_ovf);
    if (usable(ovf_hdr[slot * k_ovf + p], ts_vec, n_ts)) return {true, 2, p};
  }
  return {false, 2, ring_pos(on, 0, k_ovf)};
}

}  // namespace probe
