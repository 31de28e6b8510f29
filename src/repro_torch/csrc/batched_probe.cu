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
//
// Bound: the loads are random, so each touches its own 32-byte sector:
// the probe chain's keys, one value, 1 + K + KO headers (one 8-byte load
// each, straight from the interleaved [.,2] planes — no plane split), the
// two ring counters and one ts_vec word per header. There is no reuse
// across lanes to exploit; the design keeps every access a single
// aligned load and exits each walk as early as the data allows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kDeleted = 1u << 1;
constexpr uint32_t kMoved = 1u << 2;
constexpr int kThreadShift = 3;

__device__ __forceinline__ bool usable(uint2 h, const uint32_t* ts, int n_ts) {
  uint32_t tid = h.x >> kThreadShift;
  uint32_t t = ts[tid < (uint32_t)(n_ts - 1) ? tid : (uint32_t)(n_ts - 1)];
  return h.y <= t && (h.x & kDeleted) == 0;
}

__device__ __forceinline__ int ring_pos(int next, int age, int k) {
  int p = (next - 1 - age) % k;  // jnp.mod: the result takes k's sign
  return p < 0 ? p + k : p;
}

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
  bool got = false;
  if (keyed) {
    const uint32_t key = keys[q];
    const uint32_t key1 = key + 1u;
    const uint64_t base = (uint64_t)(key * 2654435769u) % (uint64_t)n_buckets;
    for (int p = 0; p < max_probes; ++p) {
      const uint64_t idx = (base + (uint64_t)p) % (uint64_t)n_buckets;
      const uint32_t k = dir_keys[idx];
      if (k == key1) {
        val = dir_vals[idx];
        got = val >= 0;
        break;
      }
      if (k == 0u) break;
    }
  }
  const int32_t fb = fallback[q];
  int64_t slot;
  if (keyed) {
    slot = got ? val : 0;
  } else {
    slot = fb < 0 ? (int64_t)fb + n_rec : (int64_t)fb;
    slot = slot < 0 ? 0 : (slot >= n_rec ? n_rec - 1 : slot);
  }
  if (slot >= n_rec) slot = n_rec - 1;  // a corrupt directory value

  // ---- 2. current version --------------------------------------------------
  const bool cur_ok = usable(cur_hdr[slot], ts_vec, n_ts);

  // ---- 3. old-version ring, newest first -----------------------------------
  const int nw = next_write[slot];
  int old_pos = ring_pos(nw, 0, k_old);
  bool any_old = false;
  if (!cur_ok) {
    for (int a = 0; a < k_old; ++a) {
      const int p = ring_pos(nw, a, k_old);
      const uint2 h = old_hdr[slot * k_old + p];
      const bool sentinel = h.y == 0u && (h.x >> kThreadShift) == 0u &&
                            (h.x & kMoved) != 0u;
      if (!sentinel && usable(h, ts_vec, n_ts)) {
        old_pos = p;
        any_old = true;
        break;
      }
    }
  }

  // ---- 4. overflow ring, newest first --------------------------------------
  // scanned only when neither earlier region served the read: otherwise
  // no output depends on it
  const int on = ovf_next[slot];
  int ovf_pos = ring_pos(on, 0, k_ovf);
  bool any_ovf = false;
  if (!cur_ok && !any_old) {
    for (int a = 0; a < k_ovf; ++a) {
      const int p = ring_pos(on, a, k_ovf);
      if (usable(ovf_hdr[slot * k_ovf + p], ts_vec, n_ts)) {
        ovf_pos = p;
        any_ovf = true;
        break;
      }
    }
  }

  const bool key_ok = !keyed || got;
  o_slot[q] = keyed ? (got ? val : -1) : fb;
  o_found[q] = key_ok && (cur_ok || any_old || any_ovf);
  o_src[q] = cur_ok ? 0 : (any_old ? 1 : 2);
  o_pos[q] = cur_ok ? 0 : (any_old ? old_pos : ovf_pos);
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
