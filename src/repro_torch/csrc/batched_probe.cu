// Batched read-set resolution: §5.2 directory probe + §5.1 version location.
//
// Replaces the TPU kernel src/repro/kernels/hash_probe/kernel.py:
// batched_probe (body _batched_kernel, with _dir_probe and
// _resolve_versions). The TPU launch stages the whole bucket array and all
// header planes in VMEM; a 2^24-bucket directory (128 MB) and 162 MB of
// header planes do not fit in an SM's 227 KB or in the 50 MB L2, so every
// lane works from device memory.
//
// A tile of probe::kGroup threads serves one lane with probe_common.cuh's
// tile probe (its note gives the bound and the design): a keyed lane
// probes the directory a window at a time (tile_dir_probe), a slot lane
// takes its fallback slot with JAX gather semantics (wrap once, clamp), and
// every lane locates its newest usable version with all headers loaded at
// once (tile_resolve). A keyed miss resolves slot 0. n_buckets == 0 skips
// the directory (locate-only).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

using probe::kGroup;
using probe::kThreads;

__global__ void __launch_bounds__(kThreads) batched_probe_kernel(
    const uint32_t* __restrict__ dir_keys, const int32_t* __restrict__ dir_vals,
    uint32_t n_buckets, int max_probes,
    const uint2* __restrict__ cur_hdr, const uint2* __restrict__ old_hdr,
    const int32_t* __restrict__ next_write, const uint2* __restrict__ ovf_hdr,
    const int32_t* __restrict__ ovf_next, const uint32_t* __restrict__ ts_vec,
    int n_ts, int64_t n_rec, int k_old, int k_ovf,
    const int32_t* __restrict__ fallback, const uint32_t* __restrict__ keys,
    const uint8_t* __restrict__ key_mask, int64_t n_q,
    int32_t* __restrict__ o_slot, uint8_t* __restrict__ o_found,
    int32_t* __restrict__ o_src, int32_t* __restrict__ o_pos) {
  const probe::Tile tile =
      cg::tiled_partition<kGroup>(cg::this_thread_block());
  const int64_t q =
      (int64_t)blockIdx.x * (kThreads / kGroup) + tile.meta_group_rank();
  if (q >= n_q) return;  // the whole tile leaves together

  const bool keyed = n_buckets > 0 && key_mask[q] != 0;
  const int32_t fb = fallback[q];
  int32_t val = -1;
  bool got = false;
  int64_t slot;
  if (keyed) {
    got = probe::tile_dir_probe(tile, dir_keys, dir_vals, n_buckets,
                                max_probes, keys[q], &val);
    slot = got ? val : 0;
  } else {
    slot = fb < 0 ? (int64_t)fb + n_rec : (int64_t)fb;
    slot = slot < 0 ? 0 : (slot >= n_rec ? n_rec - 1 : slot);
  }
  if (slot >= n_rec) slot = n_rec - 1;  // a corrupt directory value

  const probe::Loc loc =
      probe::tile_resolve(tile, slot, cur_hdr, old_hdr, next_write, ovf_hdr,
                          ovf_next, ts_vec, n_ts, k_old, k_ovf);
  if (tile.thread_rank() == 0) {
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
  if (n_buckets < 0 || n_buckets > (int64_t)UINT32_MAX)
    return (int)cudaErrorInvalidValue;  // bucket arithmetic is 32-bit
  constexpr int lanes = kThreads / kGroup;
  const unsigned blocks = (unsigned)((n_q + lanes - 1) / lanes);
  batched_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)dir_keys, (const int32_t*)dir_vals, (uint32_t)n_buckets,
      max_probes, (const uint2*)cur_hdr, (const uint2*)old_hdr,
      (const int32_t*)next_write, (const uint2*)ovf_hdr,
      (const int32_t*)ovf_next, (const uint32_t*)ts_vec, n_ts, n_rec, k_old,
      k_ovf, (const int32_t*)fallback, (const uint32_t*)keys,
      (const uint8_t*)key_mask, n_q, (int32_t*)o_slot, (uint8_t*)o_found,
      (int32_t*)o_src, (int32_t*)o_pos);
  return (int)cudaGetLastError();
}
