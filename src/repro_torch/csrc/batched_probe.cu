// Batched read-set resolution: §5.2 directory probe + §5.1 version location.
//
// Replaces the TPU kernel src/repro/kernels/hash_probe/kernel.py:
// batched_probe (body _batched_kernel, with _dir_probe and
// _resolve_versions). The TPU launch stages the whole bucket array and all
// header planes in VMEM; a 1.4 GB pool and a 2^24-bucket directory do not
// fit in an SM's 227 KB, so here every lane works from global memory.
//
// One thread per lane. A keyed lane walks its linear probe chain with early
// exit (at most max_probes buckets: stop at its key or an empty bucket; a
// value < 0 is an invalidated entry and counts as a miss). A slot lane takes
// its fallback slot with JAX gather semantics (negative wraps once, then
// clamp). Every lane then resolves the newest usable version: current
// header, old ring newest-first (skipping the never-written sentinel), then
// the overflow ring. A version is usable iff cts <= T_R[min(tid, n-1)] and
// its deleted bit is clear. n_buckets == 0 skips the directory (locate-only).
// The walk and the location are probe_common.cuh's, shared with hash_probe.cu.
//
// Bound: the loads are random, so each touches its own 32-byte sector:
// the probe chain's keys, one value, 1 + K + KO headers (one 8-byte load
// each, straight from the interleaved [.,2] planes — no plane split), the
// two ring counters and one ts_vec word per header. There is no reuse
// across lanes to exploit; the design keeps every access a single
// aligned load and exits each walk as early as the data allows.
#include <cstdint>
#include <cuda_runtime.h>

#include "probe_common.cuh"

namespace {

__global__ void batched_probe_kernel(
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
  int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_q) return;

  // ---- 1. slot: directory probe (keyed lanes) or the fallback slot -------
  const bool keyed = n_buckets > 0 && key_mask[q] != 0;
  int32_t val = -1;
  const bool got = keyed && probe::dir_probe(dir_keys, dir_vals, n_buckets,
                                             max_probes, keys[q], &val);
  const int32_t fb = fallback[q];
  int64_t slot;
  if (keyed) {
    slot = got ? val : 0;
  } else {
    slot = fb < 0 ? (int64_t)fb + n_rec : (int64_t)fb;
    slot = slot < 0 ? 0 : (slot >= n_rec ? n_rec - 1 : slot);
  }
  if (slot >= n_rec) slot = n_rec - 1;  // a corrupt directory value

  // ---- 2. newest usable version: current, old ring, overflow ring --------
  const probe::Loc loc = probe::resolve_versions(
      slot, cur_hdr, old_hdr, next_write, ovf_hdr, ovf_next, ts_vec, n_ts,
      k_old, k_ovf);

  o_slot[q] = keyed ? (got ? val : -1) : fb;
  o_found[q] = (!keyed || got) && loc.found;
  o_src[q] = loc.src;
  o_pos[q] = loc.pos;
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
  const int threads = 128;
  const unsigned blocks = (unsigned)((n_q + threads - 1) / threads);
  batched_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)dir_keys, (const int32_t*)dir_vals, n_buckets,
      max_probes, (const uint2*)cur_hdr, (const uint2*)old_hdr,
      (const int32_t*)next_write, (const uint2*)ovf_hdr,
      (const int32_t*)ovf_next, (const uint32_t*)ts_vec, n_ts, n_rec, k_old,
      k_ovf, (const int32_t*)fallback, (const uint32_t*)keys,
      (const uint8_t*)key_mask, n_q, (int32_t*)o_slot, (uint8_t*)o_found,
      (int32_t*)o_src, (int32_t*)o_pos);
  return (int)cudaGetLastError();
}
