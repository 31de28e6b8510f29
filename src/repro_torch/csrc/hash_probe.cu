// Single-key §5.2 directory probe + §5.1 version location.
//
// Replaces the TPU kernel src/repro/kernels/hash_probe/kernel.py:hash_probe
// (body _probe_kernel, with _dir_probe and _resolve_versions). The TPU
// launch stages the bucket array and every header plane in VMEM and walks
// a block of queries per grid step; a 2^24-bucket directory and a 1.4 GB
// pool do not fit in an SM's 227 KB, so here every query works from global
// memory.
//
// Bound: a few random 32-byte sectors a query (the probe window, one value,
// the slot's headers, ring counters and ts_vec words), far below a
// microsecond of bytes at every size the port runs; the time is the chain
// of dependent loads above the launch floor. One tile of probe::kGroup
// threads serves one query with probe_common.cuh's tile probe, the design
// batched_probe.cu shares (its note gives the trips it saves): a window of
// buckets at once, then every header of the slot at once. The contract
// differs from batched_probe on a miss: a missing or invalidated key gives
// slot -1, found 0 and src = pos = 0, and its tile loads no header at all.
// A directory value at or past the pool reads the last record (JAX gathers
// clamp), while the slot output keeps the raw value.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

using probe::kGroup;
using probe::kThreads;

__global__ void __launch_bounds__(kThreads) hash_probe_kernel(
    const uint32_t* __restrict__ dir_keys, const int32_t* __restrict__ dir_vals,
    uint32_t n_buckets, int max_probes,
    const uint2* __restrict__ cur_hdr, const uint2* __restrict__ old_hdr,
    const int32_t* __restrict__ next_write, const uint2* __restrict__ ovf_hdr,
    const int32_t* __restrict__ ovf_next, const uint32_t* __restrict__ ts_vec,
    int n_ts, int64_t n_rec, int k_old, int k_ovf,
    const uint32_t* __restrict__ queries, int64_t n_q,
    int32_t* __restrict__ o_slot, uint8_t* __restrict__ o_found,
    int32_t* __restrict__ o_src, int32_t* __restrict__ o_pos) {
  const probe::Tile tile =
      cg::tiled_partition<kGroup>(cg::this_thread_block());
  const int64_t q =
      (int64_t)blockIdx.x * (kThreads / kGroup) + tile.meta_group_rank();
  if (q >= n_q) return;  // the whole tile leaves together
  const bool lead = tile.thread_rank() == 0;

  int32_t val;
  if (!probe::tile_dir_probe(tile, dir_keys, dir_vals, n_buckets, max_probes,
                             queries[q], &val)) {
    if (lead) {
      o_slot[q] = -1;
      o_found[q] = 0;
      o_src[q] = 0;
      o_pos[q] = 0;
    }
    return;  // the tile agrees on the miss
  }
  const int64_t slot = val < n_rec ? (int64_t)val : n_rec - 1;
  const probe::Loc loc =
      probe::tile_resolve(tile, slot, cur_hdr, old_hdr, next_write, ovf_hdr,
                          ovf_next, ts_vec, n_ts, k_old, k_ovf);
  if (lead) {
    o_slot[q] = val;
    o_found[q] = loc.found;
    o_src[q] = loc.src;
    o_pos[q] = loc.pos;
  }
}

}  // namespace

extern "C" int hash_probe_launch(
    const void* dir_keys, const void* dir_vals, int64_t n_buckets,
    int max_probes, const void* cur_hdr, const void* old_hdr,
    const void* next_write, const void* ovf_hdr, const void* ovf_next,
    const void* ts_vec, int n_ts, int64_t n_rec, int k_old, int k_ovf,
    const void* queries, int64_t n_q, void* o_slot, void* o_found,
    void* o_src, void* o_pos, void* stream) {
  if (n_q == 0) return (int)cudaGetLastError();
  if (n_buckets < 0 || n_buckets > (int64_t)UINT32_MAX)
    return (int)cudaErrorInvalidValue;  // bucket arithmetic is 32-bit
  constexpr int lanes = kThreads / kGroup;
  const unsigned blocks = (unsigned)((n_q + lanes - 1) / lanes);
  hash_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)dir_keys, (const int32_t*)dir_vals, (uint32_t)n_buckets,
      max_probes, (const uint2*)cur_hdr, (const uint2*)old_hdr,
      (const int32_t*)next_write, (const uint2*)ovf_hdr,
      (const int32_t*)ovf_next, (const uint32_t*)ts_vec, n_ts, n_rec, k_old,
      k_ovf, (const uint32_t*)queries, n_q, (int32_t*)o_slot,
      (uint8_t*)o_found, (int32_t*)o_src, (int32_t*)o_pos);
  return (int)cudaGetLastError();
}
