"""The port's CUDA kernels against their plain versions, on the card.

This file imports no JAX (the machine with the card has none): it builds
its cases with numpy and the port alone, and ``test_torch_kernels.py``
reuses the same case functions to hold the plain versions against the
reference. Every test here is marked ``gpu`` and skips without a card;
run them there with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
The protocol kernels' outputs are integers or bools: the tolerance is
exact equality. The LM kernels' outputs are floats, held to the
reference's tolerances (``LM_TOL``, ``MAMBA_TOL`` of
``repro_torch.kernels.tolerance``: those of ``tests/test_kernels.py``);
the bf16 tensor-core routes of flash attention and the expert FFN are also
held against the plain version on float32 copies of their inputs at
``F32_PLAIN_RTOL`` and ``F32_PLAIN_ATOL_RMS``, the limits that tell their
split second operand from a single bf16 rounding.
"""
import numpy as np
import pytest
import torch

from repro_torch._u32 import np_to_i32
from repro_torch.configs import get_arch, reduced
from repro_torch.core import cas as tcas, header as theader, \
    hashtable as tht, mvcc as tmvcc, si as tsi, store
from repro_torch.core import tsoracle as tts
from repro_torch.core.tsoracle import PartitionedVectorOracle, VectorOracle
from repro_torch.db import tpcc, workload
from repro_torch.kernels.commit import ops as commit_ops
from repro_torch.kernels.commit.ref import fused_commit_ref, make_visible
from repro_torch.kernels._cuda import MAX_SMEM
from repro_torch.kernels.hash_probe import ops as probe_ops
from repro_torch.kernels.hash_probe.ref import batched_probe_ref, \
    hash_probe_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.tolerance import F32_PLAIN_ATOL_RMS, \
    F32_PLAIN_RTOL, LM_TOL, MAMBA_TOL
from repro_torch.kernels import _build
from repro_torch.models import api, blocks, common, moe, recurrent, \
    transformer
from repro_torch.serve import engine, kvcache as kvc


def _t(a, device="cpu"):
    return torch.from_numpy(np_to_i32(a)).to(device)


def _assert_leaves_equal(ref, port, names):
    for name, a, b in zip(names, ref, port):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np_to_i32(np.asarray(a))
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ----------------------------------------------------------- probe cases ----
def _hdr(tid, cts, flags):
    return np.stack([(np.asarray(tid, np.uint32) << 3) | flags,
                     np.asarray(cts, np.uint32)], axis=-1).astype(np.uint32)


def _probe_table(seed, R=48, K=2, KO=4, W=4, n_ts=4):
    """Populated rings: random headers with thread ids past the vector,
    commit stamps near 2**32, deleted and moved bits, never-written
    sentinels and ring counters past several revolutions."""
    rng = np.random.RandomState(seed)
    big = np.uint32(0xFFFFFFF0)

    def hdrs(shape, moved_p, deleted_p):
        tid = rng.randint(0, n_ts + 3, shape)
        cts = rng.randint(0, 12, shape).astype(np.uint32)
        cts = np.where(rng.rand(*shape) < 0.1, big, cts)
        flags = (np.where(rng.rand(*shape) < moved_p, 4, 0)
                 | np.where(rng.rand(*shape) < deleted_p, 2, 0))
        return _hdr(tid, cts, flags)

    old = hdrs((R, K), 0.5, 0.1)
    sentinel = rng.rand(R, K) < 0.25
    old[sentinel] = _hdr(0, 0, 4)
    tbl = dict(
        cur_hdr=hdrs((R,), 0.0, 0.15),
        cur_data=rng.randint(0, 1000, (R, W)).astype(np.int32),
        old_hdr=old,
        old_data=rng.randint(0, 1000, (R, K, W)).astype(np.int32),
        next_write=rng.randint(0, 5 * K, R).astype(np.int32),
        ovf_hdr=hdrs((R, KO), 0.0, 0.3),
        ovf_data=rng.randint(0, 1000, (R, KO, W)).astype(np.int32),
        ovf_next=rng.randint(0, KO, R).astype(np.int32))
    # rows 0-3 pin every outcome: served by the current version, by the
    # old ring, by the overflow ring, and by nothing
    dead = _hdr(1, 0, 2)
    tbl["cur_hdr"][0] = _hdr(1, 0, 0)
    tbl["cur_hdr"][1:4] = dead
    tbl["old_hdr"][1] = [_hdr(1, 0, 0), dead]
    tbl["old_hdr"][2:4] = dead
    tbl["ovf_hdr"][2] = [dead, _hdr(1, 0, 0), dead, dead]
    tbl["ovf_hdr"][3] = dead
    ts = rng.randint(0, 12, n_ts).astype(np.uint32)
    ts[-1] = np.uint32(0xFFFFFFFF)
    return tbl, ts


def probe_case(seed, R=48, n_buckets=128, slot_oob=False):
    """Mixed read-set over ``_probe_table``: keyed lanes (hits, absent
    keys, invalidated entries, duplicate keys, keys near 2**32) and slot
    lanes (optionally out of range). Returns numpy arrays
    ``(dir_keys, dir_vals, table, ts_vec, fallback, keys, key_mask)``."""
    rng = np.random.RandomState(seed + 100)
    tbl, ts = _probe_table(seed, R=R)
    keys = (np.arange(1, R + 1, dtype=np.uint64) * 2654435761 % (1 << 32)
            ).astype(np.uint32)
    keys[:3] = [0xFFFFFFFE, 0xFFFFFFFD, 0x80000000]
    d, placed = tht.insert(tht.init(n_buckets, device="cpu"), _t(keys),
                           torch.arange(R, dtype=torch.int32), max_probes=32)
    assert (placed >= 0).all()
    d.vals[placed[3:5].long()] = -1           # invalidated entries
    Q = 2 * R
    lane_keys = keys[rng.randint(0, R, Q)]
    lane_keys[1::5] = lane_keys[0]
    lane_keys[rng.rand(Q) < 0.2] = np.uint32(0xDEADBEEF)      # absent
    lane_keys[7] = np.uint32(0xFFFFFFFF)                      # key+1 wraps
    key_mask = rng.rand(Q) < 0.6
    fallback = rng.randint(0, R, Q).astype(np.int32)
    fallback[10:14], key_mask[10:14] = np.arange(4), False
    if slot_oob:
        fallback[[2, 9]] = [-3, R + 5]
    return (d.keys.numpy().view(np.uint32), d.vals.numpy(), tbl, ts,
            fallback, lane_keys, key_mask)


def probe_chain_case(seed, n_ts=4, R=300, n_buckets=256, n_keys=230):
    """A directory at load 0.9, so that probe chains run past one tile's
    window of 16 buckets, over ``_probe_table`` rows with a vector of ``n_ts``
    words (beyond the kernel's shared buffer at 9,000): hits deep in their
    chains, absent keys, invalidated entries, keys near 2**32, reads that
    find nothing, and slot lanes in and out of range. Returns what
    :func:`probe_case` does; its lanes' probe distances are in
    ``probe_distance``."""
    rng = np.random.RandomState(seed + 200)
    tbl, ts = _probe_table(seed, R=R, n_ts=n_ts)
    keys = np.unique(rng.randint(1, 1 << 31, 2 * n_keys))[:n_keys]
    keys = rng.permutation(keys).astype(np.uint32) * 2
    keys[:2] = [0xFFFFFFFE, 0x80000000]
    d, placed = tht.insert(tht.init(n_buckets, device="cpu"), _t(keys),
                           _t(rng.randint(0, R, n_keys).astype(np.int32)),
                           max_probes=n_buckets)
    assert (placed >= 0).all()
    d.vals[placed[rng.rand(n_keys) < 0.1].long()] = -1   # invalidated
    Q = 3 * R
    lane_keys = keys[rng.randint(0, n_keys, Q)]
    lane_keys[rng.rand(Q) < 0.15] = np.uint32(0xDEADBEEF)        # absent
    lane_keys[3] = np.uint32(0xFFFFFFFF)                         # +1 wraps
    key_mask = rng.rand(Q) < 0.7
    fallback = rng.randint(0, R, Q).astype(np.int32)
    fallback[[5, 6, 7, 8]] = [-2, R + 3, -R - 4, 3]
    key_mask[[5, 6, 7, 8]] = False
    return (d.keys.numpy().view(np.uint32), d.vals.numpy(), tbl, ts,
            fallback, lane_keys, key_mask)


def hash_probe_edge_case(seed, n_buckets, R=48):
    """A directory for the tile probe's edges over ``_probe_table`` rows:
    keys placed by ``hashtable.insert`` (at load 0.7, every bucket with one
    bucket), then values rewritten to invalidated entries (< 0) and to
    values at or past R, and empty buckets given valid values (the key
    0xFFFFFFFF is stored as 0 and hits the first empty bucket, as in the
    reference). With few buckets the windows wrap onto themselves; at 64
    chains cross the end of the array. Queries are stored keys, absent keys
    and 0xFFFFFFFF. Returns what :func:`probe_case` does (every lane a
    query)."""
    rng = np.random.RandomState(seed + 300)
    tbl, ts = _probe_table(seed, R=R)
    n_keys = max(1, int(0.7 * n_buckets))
    keys = (rng.randint(1, 1 << 31, n_keys).astype(np.uint32) * 2 + 1)
    d, placed = tht.insert(tht.init(n_buckets, device="cpu"), _t(keys),
                           _t(rng.randint(0, R, n_keys).astype(np.int32)),
                           max_probes=n_buckets)
    assert (placed >= 0).all()
    dk, dv = d.keys.numpy().view(np.uint32).copy(), d.vals.numpy().copy()
    dv[(dk != 0) & (rng.rand(n_buckets) < 0.25)] = -3          # invalidated
    dv[(dk != 0) & (rng.rand(n_buckets) < 0.25)] = R + 2       # past R
    dv[dk == 0] = rng.randint(0, R, int((dk == 0).sum()))
    Q = 96
    lane_keys = keys[rng.randint(0, n_keys, Q)]
    lane_keys[rng.rand(Q) < 0.2] = np.uint32(0xDEADBEEF)       # absent
    lane_keys[::11] = np.uint32(0xFFFFFFFF)                    # key+1 wraps
    return (dk, dv, tbl, ts, np.zeros(Q, np.int32), lane_keys,
            np.ones(Q, bool))


HASH_PROBE_EDGES = [(n, mp) for n in (1, 3, 15, 64) for mp in (1, 17, 32)]


def probe_distance(case):
    """Buckets each keyed lane's walk reads before its key or an empty
    bucket (the chain length the kernel's windows must cover)."""
    dk, dv, tbl, ts, fb, lk, km = case
    B = dk.shape[0]
    base = tht._hash(_t(lk), B).numpy()
    dist = np.full(lk.shape, B)
    for p in range(B - 1, -1, -1):
        k = dk[(base + p) % B]
        dist = np.where((k == lk + np.uint32(1)) | (k == 0), p + 1, dist)
    return np.where(km, dist, 0)


def port_table(tbl, device="cpu"):
    return tmvcc.VersionedTable(**{k: _t(v, device) for k, v in tbl.items()})


def port_probe(fn, case, device="cpu", max_probes=32):
    dk, dv, tbl, ts, fb, lk, km = case
    return fn(_t(dk, device), _t(dv, device), port_table(tbl, device),
              _t(ts, device), _t(fb, device), _t(lk, device),
              _t(km, device), max_probes=max_probes)


PROBE_OUT = ("slot", "found", "src", "pos")


def port_hash_probe(fn, case, device="cpu", max_probes=32):
    """``hash_probe`` over a :func:`probe_case`: every lane's key is a
    query (the lanes' slot addressing does not apply)."""
    dk, dv, tbl, ts, fb, lk, km = case
    return fn(_t(dk, device), _t(dv, device), port_table(tbl, device),
              _t(ts, device), _t(lk, device), max_probes=max_probes)


def check_hash_probe_gather(case, out, device="cpu", max_probes=32):
    """``mvcc.gather_version`` over the locator equals ``lookup`` +
    ``read_visible`` on every found lane, and a miss is slot -1 with
    src = pos = 0."""
    dk, dv, tbl, ts, fb, lk, km = case
    table = port_table(tbl, device)
    slot, found, src, pos = out
    hdr, data = tmvcc.gather_version(
        table, torch.where(found, slot, 0),
        tmvcc.VersionLoc(found=found, src=src, pos=pos))
    vals, kfound = tht.lookup(tht.HashTable(_t(dk, device), _t(dv, device)),
                              _t(lk, device), max_probes=max_probes)
    vr = tmvcc.read_visible(table, torch.where(kfound, vals, 0),
                            _t(ts, device))
    assert torch.equal(found, kfound & vr.found)
    assert torch.equal(hdr[found], vr.hdr[found])
    assert torch.equal(data[found], vr.data[found])
    miss = ~kfound
    assert (slot[miss] == -1).all() and (src[miss] == 0).all() \
        and (pos[miss] == 0).all()


# ---------------------------------------------------------- commit cases ----
def commit_case(wrap_seed=0):
    """The whole outcome lattice, by construction (T=8 transactions of
    WS=3 requests; prio = transaction id, lower wins):

    txn0 commits on clean slots, winning hot slot 1 against txn1;
    txn1 loses slot 1 and releases its grants on 5 and 7;
    txn2 carries a stale expectation on 8 (CAS denial) and releases 10;
    txn3 targets locked slot 22 and releases 13;
    txn4 wins slot 3 whose ring victim is not moved, and releases 14;
    txn5 is gated off by ``txn_ok`` and releases 16 and 17;
    txn6 commits with a padding lane carrying garbage slot and txn ids;
    txn7 is aborted by ``ext_fails`` and releases 23 and 25.
    Ring counters sit past several revolutions (installs land mod K).
    Returns ``(table, args)`` in numpy, ``args`` in ``fused_commit``'s
    order after the table."""
    R, K, W, T, WS = 64, 2, 4, 8, 3
    rng = np.random.RandomState(wrap_seed)
    r = np.arange(R)
    cur = _hdr(r % 4, r % 5, np.where(r % 11 == 0, 1, 0))
    old = np.broadcast_to(_hdr(0, 0, 4), (R, K, 2)).copy()
    old[r % 3 == 0] = _hdr(1, 1, 0)            # victims not yet moved
    tbl = dict(
        cur_hdr=cur, cur_data=rng.randint(0, 1000, (R, W)).astype(np.int32),
        old_hdr=old, old_data=rng.randint(0, 1000, (R, K, W)).astype(np.int32),
        next_write=rng.randint(0, 5 * K, R).astype(np.int32),
        ovf_hdr=np.broadcast_to(_hdr(0, 0, 2), (R, 2, 2)).copy(),
        ovf_data=np.zeros((R, 2, W), np.int32),
        ovf_next=np.zeros(R, np.int32))
    slots = np.array([[1, 2, 4], [1, 5, 7], [8, 10, 11], [22, 13, 26],
                      [3, 14, 28], [16, 17, 29], [19, 20, 999],
                      [23, 25, 31]], np.int32)
    active = np.ones((T, WS), bool)
    active[2:8, 2] = False
    txn = np.repeat(np.arange(T, dtype=np.int32)[:, None], WS, 1)
    txn[6, 2] = 999
    expected = cur[np.clip(slots, 0, R - 1)]
    expected[2, 0, 1] += 1                      # stale expectation
    vec = rng.randint(0, 5, T).astype(np.uint32)
    cts = vec + np.uint32(1)
    new_hdr = _hdr(np.repeat(np.arange(T), WS), np.repeat(cts, WS), 0)
    txn_ok = np.ones(T, bool)
    txn_ok[5] = False
    ext = np.zeros(T, np.int32)
    ext[7] = 1
    args = (vec, slots.reshape(-1), expected.reshape(-1, 2),
            txn.reshape(-1).astype(np.uint32), active.reshape(-1),
            txn.reshape(-1), new_hdr,
            rng.randint(0, 1000, (T * WS, W)).astype(np.int32), txn_ok,
            np.arange(T, dtype=np.int32), cts, ext)
    return tbl, args


# out-of-range write slots as (a, b): slot a*R + b of a table of R records
OOB_SLOTS = {"R-1": (1, -1), "R": (1, 0), "R+5": (1, 5), "-1": (0, -1),
             "-R": (-1, 0), "-R-1": (-1, -1)}


def gather_slot(s, R):
    """The record a gather reads at slot ``s``: wrap once, then clamp."""
    s = s + R if s < 0 else s
    return min(max(s, 0), R - 1)


def commit_oob_case(name, same_prio=False, wrap_seed=0):
    """``commit_case`` with txn0's third request (lane 2) aimed at slot
    ``name`` of ``OOB_SLOTS``, expecting the header a gather reads there.
    With ``same_prio`` txn0's second request (lane 1) targets that gathered
    record, unlocked and with its ring victims moved: lane 2 then shares
    its priority with the record's winner, so it is granted and txn0
    commits, though a slot still out of range once negatives wrap writes
    nothing (a scatter drops it)."""
    tbl, args = commit_case(wrap_seed)
    R = tbl["cur_hdr"].shape[0]
    a, b = OOB_SLOTS[name]
    slots, expected = args[1].copy(), args[2].copy()
    slots[2] = a * R + b
    g = gather_slot(int(slots[2]), R)
    if same_prio:
        tbl["cur_hdr"][g, 0] &= ~np.uint32(1)
        tbl["old_hdr"][g, :, 0] |= np.uint32(4)
        slots[1] = g
        expected[1] = tbl["cur_hdr"][g]
    expected[2] = tbl["cur_hdr"][g]
    return tbl, (args[0], slots, expected) + args[3:]


def commit_dup_case(across=False, wrap_seed=0):
    """``commit_case`` with two committing requests on record 19 carrying
    different payloads: txn6's second request (lane 19) joins its first
    (lane 18), or, ``across``, txn0's third request (lane 2) joins lane 18
    and txn6 takes txn0's priority 0, so two transactions of one priority
    both win and commit. Both move the same current version and advance
    ``next_write``; the highest lane's version becomes current."""
    tbl, args = commit_case(wrap_seed)
    slots, expected, prio = (a.copy() for a in args[1:4])
    lane = 2 if across else 19
    slots[lane] = 19
    expected[lane] = tbl["cur_hdr"][19]
    if across:
        prio[18:21] = 0
    return tbl, (args[0], slots, expected, prio) + args[4:]


def commit_many_case(seed=0, R=1 << 17, T=2500, WS=8, W=8, K=2):
    """Q = T*WS = 20,000 requests, more than one pass of the commit
    kernel's cluster: hot slots shared across transactions, records
    written twice by one transaction, pairs of transactions of one
    priority, stale expectations, locked targets, unmoved ring victims,
    ring counters past several revolutions, write slots out of range
    (R-1, R, R+5, -1, -R, -R-1), padding lanes with garbage ids, remote
    failures, gated-off transactions and vector slots out of range.
    Returns ``(table, args)`` as :func:`commit_case` does."""
    rng = np.random.RandomState(seed)
    Q = T * WS
    r = np.arange(R)
    cur = _hdr(r % 7, rng.randint(0, 50, R), np.where(rng.rand(R) < 0.01,
                                                       1, 0))
    old = np.broadcast_to(_hdr(0, 0, 4), (R, K, 2)).copy()
    old[rng.rand(R, K) < 0.03] = _hdr(1, 1, 0)           # not yet moved
    tbl = dict(
        cur_hdr=cur, cur_data=rng.randint(0, 1000, (R, W)).astype(np.int32),
        old_hdr=old, old_data=rng.randint(0, 1000, (R, K, W)).astype(np.int32),
        next_write=rng.randint(0, 7 * K, R).astype(np.int32),
        ovf_hdr=np.broadcast_to(_hdr(0, 0, 2), (R, 2, 2)).copy(),
        ovf_data=np.zeros((R, 2, W), np.int32),
        ovf_next=np.zeros(R, np.int32))
    slots = rng.randint(0, R, (T, WS)).astype(np.int32)
    hot = rng.rand(T, WS) < 0.01
    slots[hot] = rng.randint(0, 16, hot.sum())
    twice = rng.rand(T) < 0.05
    slots[twice, 1] = slots[twice, 0]
    slots = slots.reshape(-1)
    oob = rng.rand(Q) < 0.01
    slots[oob] = rng.choice([R - 1, R, R + 5, -1, -R, -R - 1], oob.sum())
    gathered = np.clip(np.where(slots < 0, slots + R, slots), 0, R - 1)
    expected = cur[gathered].copy()
    expected[rng.rand(Q) < 0.01, 1] += 1                    # stale
    prio = rng.permutation(T).astype(np.uint32)
    prio[1::50] = prio[0::50][:len(prio[1::50])]            # shared
    active = rng.rand(Q) < 0.95
    txn = np.repeat(np.arange(T, dtype=np.int32), WS)
    pad = ~active & (rng.rand(Q) < 0.5)
    txn[pad] = 10 ** 6
    slots[pad] = -7
    vec = rng.randint(0, 5, 64).astype(np.uint32)
    cts = rng.randint(1, 1 << 31, T).astype(np.uint32)
    new_hdr = _hdr(np.repeat(np.arange(T) % 8, WS), np.repeat(cts, WS), 0)
    txn_ok = rng.rand(T) < 0.95
    txn_slot = (np.arange(T) % 64).astype(np.int32)
    txn_slot[::97] = 70
    ext = (rng.rand(T) < 0.02).astype(np.int32)
    args = (vec, slots, expected, np.repeat(prio, WS), active, txn, new_hdr,
            rng.randint(0, 1000, (Q, W)).astype(np.int32), txn_ok, txn_slot,
            cts, ext)
    return tbl, args


COMMIT_OUT = tuple(f"table.{f}" for f in tmvcc.VersionedTable._fields) \
    + ("vec", "granted", "committed", "do_install", "fails")


def flat_commit(out):
    return tuple(out.table) + tuple(out[1:])


def port_commit(fn, case, device="cpu"):
    tbl, args = case
    return flat_commit(fn(port_table(tbl, device),
                          *(_t(a, device) for a in args)))


def check_lattice(port):
    """The constructed case reaches every outcome it was built for."""
    g, c, inst = (x.cpu().numpy() for x in port[9:12])
    assert c.tolist() == [True, False, False, False, False, False, True,
                          False]
    g, inst = g.reshape(8, 3), inst.reshape(8, 3)
    assert (g & ~c[:, None]).any() and inst.any()
    assert not g[1, 0] and not g[2, 0] and not g[3, 0]
    assert g[4, 0] and not inst[4, 0]


# ------------------------------------------------------------ card only ----
@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_probe_kernel_matches_plain_on_card(seed):
    dev = _cuda()
    case = probe_case(seed, slot_oob=True)
    n = probe_ops.batched_probe.launches
    ker = port_probe(probe_ops.batched_probe, case, dev)
    torch.cuda.synchronize()
    assert probe_ops.batched_probe.launches == n + 1
    _assert_leaves_equal(port_probe(batched_probe_ref, case), ker,
                         PROBE_OUT)
    dk, dv, tbl, ts, fb, lk, km = case
    loc = probe_ops.batched_probe(None, None, port_table(tbl, dev),
                                  _t(ts, dev), _t(fb, dev), None, None)
    _assert_leaves_equal(
        batched_probe_ref(None, None, port_table(tbl), _t(ts), _t(fb),
                          None, None), loc, PROBE_OUT)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_probe_kernel_matches_plain_on_card(seed):
    dev = _cuda()
    case = probe_case(seed)
    n = probe_ops.hash_probe.launches
    ker = port_hash_probe(probe_ops.hash_probe, case, dev)
    torch.cuda.synchronize()
    assert probe_ops.hash_probe.launches == n + 1
    _assert_leaves_equal(port_hash_probe(hash_probe_ref, case), ker,
                         PROBE_OUT)
    check_hash_probe_gather(case, ker, dev)


def check_hash_probe_edges(n_buckets, max_probes, out):
    """What :func:`hash_probe_edge_case` must reach, on a plain or kernel
    output: misses everywhere, and with a directory larger than one window
    and a full probe budget, 0xFFFFFFFF found, values past R read as the
    last record, and every region of the resolution."""
    slot, found, src = (x.cpu().numpy() for x in out[:3])
    assert (slot == -1).any()
    if n_buckets == 64 and max_probes == 32:
        assert found[::11].any()                      # 0xFFFFFFFF hit
        assert (found & (slot >= 48)).any()           # value past R
        assert {0, 1, 2} <= set(src[found].tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("n_buckets,max_probes", HASH_PROBE_EDGES)
def test_hash_probe_kernel_edges_on_card(n_buckets, max_probes):
    """The tile probe on 1, 3, 15 and 64 buckets at 1, 17 and 32 probes:
    hit precedence for 0xFFFFFFFF, self-wrapping and partial windows,
    invalidated entries, values at or past R, all three regions."""
    dev = _cuda()
    case = hash_probe_edge_case(0, n_buckets)
    ker = port_hash_probe(probe_ops.hash_probe, case, dev,
                          max_probes=max_probes)
    torch.cuda.synchronize()
    _assert_leaves_equal(port_hash_probe(hash_probe_ref, case,
                                         max_probes=max_probes), ker,
                         PROBE_OUT)
    check_hash_probe_gather(case, ker, dev, max_probes=max_probes)
    check_hash_probe_edges(n_buckets, max_probes, ker)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_hash_probe_kernel_long_chains_on_card(seed):
    """The batched probe's long-chain case through the single-key kernel:
    chains past one window, cut inside, at and past a window."""
    dev = _cuda()
    case = probe_chain_case(seed)
    for mp in (3, 16, 17, 64):
        ker = port_hash_probe(probe_ops.hash_probe, case, dev, max_probes=mp)
        torch.cuda.synchronize()
        _assert_leaves_equal(port_hash_probe(hash_probe_ref, case,
                                             max_probes=mp), ker, PROBE_OUT)


@pytest.mark.gpu
@pytest.mark.parametrize("wrap_seed", [0, 1, 2])
def test_fused_commit_kernel_matches_plain_on_card(wrap_seed):
    dev = _cuda()
    case = commit_case(wrap_seed)
    n = commit_ops.fused_commit.launches
    ker = port_commit(commit_ops.fused_commit, case, dev)
    torch.cuda.synchronize()
    assert commit_ops.fused_commit.launches == n + 1
    _assert_leaves_equal(port_commit(fused_commit_ref, case), ker,
                         COMMIT_OUT)
    check_lattice(ker)


@pytest.mark.gpu
@pytest.mark.parametrize("n_ts", [4, 9000])
@pytest.mark.parametrize("seed", [0, 1])
def test_batched_probe_kernel_long_chains_on_card(seed, n_ts):
    """Chains past one window, invalidated entries, sentinels, reads that
    find nothing, a long vector (9,000 words)."""
    dev = _cuda()
    case = probe_chain_case(seed, n_ts=n_ts)
    assert (probe_distance(case) > 16).sum() > 20
    ker = port_probe(probe_ops.batched_probe, case, dev, max_probes=64)
    plain = port_probe(batched_probe_ref, case, max_probes=64)
    torch.cuda.synchronize()
    _assert_leaves_equal(plain, ker, PROBE_OUT)
    found, src = plain[1].numpy(), plain[2].numpy()
    assert (~found).any() and {0, 1, 2} <= set(src[found].tolist())
    for mp in (3, 16, 17):             # a chain cut inside, at, past a window
        _assert_leaves_equal(port_probe(batched_probe_ref, case,
                                        max_probes=mp),
                             port_probe(probe_ops.batched_probe, case, dev,
                                        max_probes=mp), PROBE_OUT)


@pytest.mark.gpu
@pytest.mark.parametrize("same_prio", [False, True])
@pytest.mark.parametrize("name", list(OOB_SLOTS))
def test_fused_commit_kernel_out_of_range_on_card(name, same_prio):
    """F1's cases: the kernel drops an out-of-range write and reads the
    clamped slot, as its plain version does."""
    dev = _cuda()
    case = commit_oob_case(name, same_prio)
    n = commit_ops.fused_commit.launches
    ker = port_commit(commit_ops.fused_commit, case, dev)
    torch.cuda.synchronize()
    assert commit_ops.fused_commit.launches == n + 1
    _assert_leaves_equal(port_commit(fused_commit_ref, case), ker,
                         COMMIT_OUT)


@pytest.mark.gpu
@pytest.mark.parametrize("across", [False, True], ids=["one_txn", "two_txns"])
def test_fused_commit_kernel_duplicate_slots_on_card(across):
    """Two committing requests on one record: the highest lane's version
    becomes current, every time."""
    dev = _cuda()
    case = commit_dup_case(across)
    plain = port_commit(fused_commit_ref, case)
    for _ in range(3):
        _assert_leaves_equal(plain, port_commit(commit_ops.fused_commit,
                                                case, dev), COMMIT_OUT)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_commit_kernel_many_requests_on_card(seed):
    """20,000 requests, several per thread of the cluster, equal the plain
    version bit for bit."""
    dev = _cuda()
    case = commit_many_case(seed)
    n = commit_ops.fused_commit.launches
    ker = port_commit(commit_ops.fused_commit, case, dev)
    torch.cuda.synchronize()
    assert commit_ops.fused_commit.launches == n + 1
    plain = port_commit(fused_commit_ref, case)
    _assert_leaves_equal(plain, ker, COMMIT_OUT)
    g, c, inst = (x.numpy() for x in plain[9:12])
    assert c.any() and (~c).any() and inst.any() and (g & ~inst).any()


@pytest.mark.gpu
def test_fused_commit_kernel_beyond_shared_memory_on_card():
    """80,000 requests: a block's lane state outgrows its shared memory
    and goes to the global scratch; the result still equals the plain
    version bit for bit."""
    dev = _cuda()
    case = commit_many_case(0, T=10_000)
    assert commit_ops.smem_bytes(case[1][1].shape[0]) > MAX_SMEM
    n = commit_ops.fused_commit.launches
    ker = port_commit(commit_ops.fused_commit, case, dev)
    torch.cuda.synchronize()
    assert commit_ops.fused_commit.launches == n + 1
    _assert_leaves_equal(port_commit(fused_commit_ref, case), ker,
                         COMMIT_OUT)


def _arbitration_tables_clean():
    """Every arbitration table the commit wrapper keeps holds no bid and
    no vote."""
    torch.cuda.synchronize()
    assert commit_ops._ARBITRATION
    for arb in commit_ops._ARBITRATION.values():
        assert bool((arb[:, 0] == -1).all()) and bool((arb[:, 1] == 0).all())


@pytest.mark.gpu
def test_fused_commit_leaves_its_arbitration_table_clean_on_card():
    """A launch leaves the table as it found it, so the next launch on it
    (or a replay) sees no bid or vote of an earlier one: out-of-range
    lanes, duplicate slots, many requests, one call after another."""
    dev = _cuda()
    cases = [commit_oob_case(name, same) for name in ("R", "-1", "R-1")
             for same in (False, True)]
    cases += [commit_dup_case(False), commit_dup_case(True),
              commit_many_case(1), commit_case(2)]
    for case in cases:
        _assert_leaves_equal(port_commit(fused_commit_ref, case),
                             port_commit(commit_ops.fused_commit, case, dev),
                             COMMIT_OUT)
        _arbitration_tables_clean()


@pytest.mark.gpu
def test_fused_commit_keeps_one_table_a_stream_on_card():
    """Calls on another stream get a table of their own, and their result
    equals the plain version."""
    dev = _cuda()
    case = commit_case(0)
    plain = port_commit(fused_commit_ref, case)
    side = torch.cuda.Stream(dev)
    R = case[0]["cur_hdr"].shape[0]
    _assert_leaves_equal(plain, port_commit(commit_ops.fused_commit, case,
                                            dev), COMMIT_OUT)
    with torch.cuda.stream(side):
        ker = port_commit(commit_ops.fused_commit, case, dev)
    side.synchronize()
    _assert_leaves_equal(plain, ker, COMMIT_OUT)
    main = torch.cuda.current_stream(dev).cuda_stream
    assert side.cuda_stream != main
    assert {main, side.cuda_stream} <= {
        stream for _, stream, n in commit_ops._ARBITRATION if n == R}
    _arbitration_tables_clean()


@pytest.mark.gpu
def test_fused_commit_wrapper_never_waits_on_the_device():
    """The commit wrapper validates, allocates and launches: no torch op
    of it synchronises with the device."""
    dev = _cuda()
    case = commit_case(1)
    table = port_table(case[0], dev)
    args = [_t(a, dev) for a in case[1]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = commit_ops.fused_commit(table, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_leaves_equal(port_commit(fused_commit_ref, case),
                         flat_commit(out), COMMIT_OUT)


@pytest.mark.gpu
def test_wrappers_raise_on_bad_cuda_inputs():
    dev = _cuda()
    tbl, args = commit_case(0)
    bad = [_t(a, dev) for a in args]
    bad[1] = bad[1].to(torch.int64)          # req_slots of the wrong dtype
    with pytest.raises(ValueError):
        commit_ops.fused_commit(port_table(tbl, dev), *bad)


@pytest.mark.gpu
def test_empty_calls_launch_nothing_and_count_nothing():
    """A call with no lanes launches no kernel, so no count moves."""
    dev = _cuda()
    dk, dv, tbl, ts, fb, lk, km = probe_case(0)
    none = np.zeros(0, np.int32)
    n = (probe_ops.batched_probe.launches, probe_ops.hash_probe.launches)
    out = port_hash_probe(probe_ops.hash_probe,
                          (dk, dv, tbl, ts, fb, none, km), dev)
    assert all(t.shape == (0,) for t in out)
    out = port_probe(probe_ops.batched_probe,
                     (dk, dv, tbl, ts, none, none, km[:0]), dev)
    assert all(t.shape == (0,) for t in out)
    torch.cuda.synchronize()
    assert (probe_ops.batched_probe.launches,
            probe_ops.hash_probe.launches) == n


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["table_major", "warehouse_major"])
def test_neworder_kernels_match_plain_path_on_card(layout):
    """Four key-addressed new-order rounds through both kernels on the card
    equal the plain path on the CPU, state leaf for state leaf."""
    dev = _cuda()
    cfg = tpcc.TPCCConfig(n_warehouses=2, customers_per_district=8,
                          n_items=64, n_threads=8, orders_per_thread=16,
                          dist_degree=50.0, layout=layout, key_addressed=True,
                          fused_commit=True, batched_probe=True)
    plain = tpcc.TPCCConfig(**{**cfg.__dict__, "fused_commit": False,
                               "batched_probe": False})
    oracle = VectorOracle(cfg.n_threads)
    lay, st = tpcc.init_tpcc(cfg, oracle, device=dev)
    cpu_st = type(st)(*(_to(x, "cpu") for x in st))
    gen = torch.Generator().manual_seed(7)
    draws = [workload.gen_neworder(
        gen, cfg.n_threads, cfg.n_warehouses, cfg.n_items,
        cfg.customers_per_district, None, cfg.dist_degree,
        workload.zipf_logits(cfg.n_items, None, device="cpu"))
        for _ in range(4)]
    n = (probe_ops.batched_probe.launches, commit_ops.fused_commit.launches)
    st, stats = tpcc.run_neworder_rounds(
        cfg, lay, st, oracle,
        lambda r: type(draws[r])(*(x.to(dev) for x in draws[r])), 4,
        device=dev)
    cpu_st, cpu_stats = tpcc.run_neworder_rounds(
        plain, lay, cpu_st, oracle, lambda r: draws[r], 4, device="cpu")
    assert probe_ops.batched_probe.launches - n[0] == 4
    assert commit_ops.fused_commit.launches - n[1] == 4
    assert stats.commits == cpu_stats.commits > 0
    assert torch.equal(stats.committed.cpu(), cpu_stats.committed)
    _assert_leaves_equal(_leaves(cpu_st), _leaves(st),
                         [str(i) for i in range(len(_leaves(st)))])


@pytest.mark.gpu
def test_mixed_rounds_kernels_match_plain_path_on_card():
    """Four key-addressed rounds of the full mix through both kernels on
    the card equal the plain path on the CPU, state leaf for state leaf;
    payment and delivery launch both kernels too."""
    dev = _cuda()
    cfg = tpcc.TPCCConfig(n_warehouses=2, customers_per_district=8,
                          n_items=64, n_threads=16, orders_per_thread=16,
                          dist_degree=50.0, key_addressed=True,
                          fused_commit=True, batched_probe=True)
    plain = tpcc.TPCCConfig(**{**cfg.__dict__, "fused_commit": False,
                               "batched_probe": False})
    oracle = VectorOracle(cfg.n_threads)
    lay, st = tpcc.init_tpcc(cfg, oracle, device=dev)
    cpu_st = _to(st, "cpu")
    draw = workload.mixed_stream(
        cfg, torch.Generator().manual_seed(3),
        mix={"neworder": 0.3, "payment": 0.3, "orderstatus": 0.1,
             "delivery": 0.2, "stocklevel": 0.1})
    draws = [draw(r) for r in range(4)]
    counts = {}
    orig = tpcc.payment_round, tpcc.delivery_round

    def counted(name, fn):
        def run(*a, **k):
            n = (probe_ops.batched_probe.launches,
                 commit_ops.fused_commit.launches)
            out = fn(*a, **k)
            counts.setdefault(name, set()).add(
                (probe_ops.batched_probe.launches - n[0],
                 commit_ops.fused_commit.launches - n[1]))
            return out
        return run

    tpcc.payment_round = counted("payment", orig[0])
    tpcc.delivery_round = counted("delivery", orig[1])
    try:
        st, stats = tpcc.run_mixed_rounds(
            cfg, lay, st, oracle, lambda r: _to(draws[r], dev), 4,
            device=dev)
    finally:
        tpcc.payment_round, tpcc.delivery_round = orig
    cpu_st, cpu_stats = tpcc.run_mixed_rounds(
        plain, lay, cpu_st, oracle, lambda r: draws[r], 4, device="cpu")
    assert counts == {"payment": {(1, 1)}, "delivery": {(1, 1)}}
    for f in cpu_stats._fields:
        if f != "local_fraction":
            assert getattr(stats, f) == getattr(cpu_stats, f), f
    assert stats.total_commits > 0
    _assert_leaves_equal(_leaves(cpu_st), _leaves(st),
                         [str(i) for i in range(len(_leaves(st)))])


@pytest.mark.gpu
def test_durable_mix_kernels_match_plain_path_on_card(tmp_path):
    """A journalled, checkpointed mix with the GC thread on, killed at
    round 3 with intents in flight and recovered, through both kernels on
    the card: state, journal, statistics and the recovery report (but its
    seconds) equal the same run on the plain path on the CPU."""
    dev = _cuda()
    cfg = tpcc.TPCCConfig(n_warehouses=2, customers_per_district=8,
                          n_items=64, n_threads=16, orders_per_thread=16,
                          dist_degree=50.0, key_addressed=True,
                          fused_commit=True, batched_probe=True)
    plain = tpcc.TPCCConfig(**{**cfg.__dict__, "fused_commit": False,
                               "batched_probe": False})
    oracle = VectorOracle(cfg.n_threads)
    lay, st = tpcc.init_tpcc(cfg, oracle, device=dev)
    cpu_st = _to(st, "cpu")
    draw = workload.mixed_stream(cfg, torch.Generator().manual_seed(5))
    draws = [draw(r) for r in range(6)]
    kw = dict(gc_interval=2, max_txn_time=1,
              failure=tpcc.FailureInjector(kill_round=3))
    n = (probe_ops.batched_probe.launches, commit_ops.fused_commit.launches)
    jnl = tpcc.make_journal(cfg, oracle, capacity_rounds=8, device=dev)
    st, stats = tpcc.run_mixed_rounds(
        cfg, lay, st, oracle, lambda r: _to(draws[r], dev), 6, journal=jnl,
        checkpoint_dir=str(tmp_path / "card"), device=dev, **kw)
    launched = (probe_ops.batched_probe.launches - n[0],
                commit_ops.fused_commit.launches - n[1])
    cpu_jnl = tpcc.make_journal(cfg, oracle, capacity_rounds=8,
                                device="cpu")
    cpu_st, cpu_stats = tpcc.run_mixed_rounds(
        plain, lay, cpu_st, oracle, lambda r: draws[r], 6, journal=cpu_jnl,
        checkpoint_dir=str(tmp_path / "cpu"), device="cpu", **kw)
    assert launched[0] > 0 and launched[1] > 0
    for f in cpu_stats._fields:
        if f not in ("local_fraction", "recovery"):
            assert getattr(stats, f) == getattr(cpu_stats, f), f
    (rep,), (cpu_rep,) = stats.recovery, cpu_stats.recovery
    assert rep._replace(recovery_seconds=0) \
        == cpu_rep._replace(recovery_seconds=0)
    assert rep.checkpoint_round == 1 and rep.undetermined > 0
    assert stats.gc_sweeps == 3 and stats.total_commits > 0
    _assert_leaves_equal(_leaves(cpu_st), _leaves(st),
                         [str(i) for i in range(len(_leaves(st)))])
    _assert_leaves_equal(cpu_jnl, jnl, cpu_jnl._fields)


# ------------------------------------------------------ memory servers ----
def decide_cases():
    """The commit cases a decide-only launch is held on."""
    cases = [(f"lattice{s}", commit_case(s)) for s in (0, 1, 2)]
    cases += [(f"oob-{n}{'-same_prio' if sp else ''}", commit_oob_case(n, sp))
              for sp in (False, True) for n in OOB_SLOTS]
    cases += [("dup-one_txn", commit_dup_case(False)),
              ("dup-two_txns", commit_dup_case(True)),
              ("many", commit_many_case(0))]
    return cases


DECIDE_IDS = [name for name, _ in decide_cases()]


def mesh_commit(case, S, fused, device="cpu"):
    """``case``'s commit over ``S`` servers of its table (contiguous views
    of ``R / S`` records) through ``store.commit_on_servers``: with
    ``fused`` the decide/apply double launch a server (the plain twins on
    the CPU), else the plain rendering, then make-visible. The case's
    ``ext_fails`` is left out: the servers' failures are the remote ones.
    Returns the table planes, the vector, granted and do_install [S, Q]
    and the decision."""
    tbl, args = case
    table = port_table(tbl, device)
    vec, slots, expected, prio, act, txn, new_hdr, new_data, txn_ok, \
        txn_slot, cts, _ = (_t(a, device) for a in args)
    committed, granted, do_install = store.commit_on_servers(
        table, vec, S, slots, expected, prio, act, txn, new_hdr, new_data,
        txn_ok, txn_slot, cts, fused_commit=fused)
    if not fused:
        make_visible(vec, txn_slot, cts, committed)
    return tuple(table) + (vec, granted, do_install, committed)


MESH_OUT = COMMIT_OUT[:9] + ("granted", "do_install", "committed")


@pytest.mark.gpu
@pytest.mark.parametrize("name", DECIDE_IDS)
def test_decide_only_launch_writes_nothing_on_card(name):
    """A decide-only launch leaves every table plane, the vector and the
    arbitration table as they were, returns no decision, and its failure
    counts equal the plain twin's."""
    dev = _cuda()
    tbl, args = dict(decide_cases())[name]
    table = port_table(tbl, dev)
    targs = [_t(a, dev) for a in args]
    before = [t.clone() for t in table] + [targs[0].clone()]
    n = commit_ops.fused_commit.launches
    out = commit_ops.fused_commit(table, *targs, decide_only=True)
    torch.cuda.synchronize()
    assert commit_ops.fused_commit.launches == n + 1
    assert out.granted is None and out.committed is None \
        and out.do_install is None
    for a, b in zip(before, list(table) + [targs[0]]):
        assert torch.equal(a, b)
    _arbitration_tables_clean()
    plain = fused_commit_ref(port_table(tbl), *(_t(a) for a in args),
                             decide_only=True)
    assert torch.equal(out.fails.cpu(), plain.fails)
    assert bool((plain.fails > 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", ["lattice0", "oob-R-1-same_prio",
                                  "dup-two_txns", "many"])
def test_decide_apply_on_shard_views_matches_plain_on_card(name, S):
    """The adversarial commit cases over ``S`` servers: each server's
    decide and apply launch on its view equal the plain mesh path (and the
    plain twins), and the arbitration table is clean after every
    launch."""
    dev = _cuda()
    case = dict(decide_cases())[name]
    n = (commit_ops.fused_commit.launches,
         commit_ops.fused_commit.decide_launches)
    ker = mesh_commit(case, S, True, dev)
    torch.cuda.synchronize()
    assert (commit_ops.fused_commit.launches - n[0],
            commit_ops.fused_commit.decide_launches - n[1]) == (2 * S, S)
    _arbitration_tables_clean()
    plain = mesh_commit(case, S, False)
    _assert_leaves_equal(plain, ker, MESH_OUT)
    _assert_leaves_equal(mesh_commit(case, S, True), ker, MESH_OUT)
    granted, committed = plain[9], plain[11]
    assert committed.any() and (~committed).any() and granted.any()


@pytest.mark.gpu
@pytest.mark.parametrize("S,key_addressed", [(2, True), (3, False)])
def test_mesh_rounds_kernels_match_plain_path_on_card(S, key_addressed):
    """Three new-order rounds and three mix rounds over ``S`` servers
    through both kernels on the card (a locate-only probe a server, a
    decide and an apply launch a server in every write sub-round) equal
    the plain path over the servers on the CPU, state leaf for state
    leaf."""
    dev = _cuda()
    cfg = tpcc.TPCCConfig(n_warehouses=2, customers_per_district=8,
                          n_items=64, n_threads=16, orders_per_thread=16,
                          dist_degree=50.0, key_addressed=key_addressed,
                          fused_commit=True, batched_probe=True)
    plain = tpcc.TPCCConfig(**{**cfg.__dict__, "fused_commit": False,
                               "batched_probe": False})
    oracle = PartitionedVectorOracle(cfg.n_threads, n_parts=S)
    lay, st = tpcc.init_tpcc(cfg, oracle, device=dev)
    cpu_st = _to(st, "cpu")
    engine = tpcc.make_mixed_engine(cfg, lay, S, oracle, shard_vector=True)
    cpu_engine = tpcc.make_mixed_engine(plain, lay, S, oracle,
                                        shard_vector=True)
    st = tpcc.distribute_state(engine, st)
    cpu_st = tpcc.distribute_state(cpu_engine, cpu_st)
    gen = torch.Generator().manual_seed(11)
    no = workload.neworder_stream(cfg, gen)
    mix = workload.mixed_stream(cfg, gen)
    no_draws = [no(r) for r in range(3)]
    mix_draws = [mix(r) for r in range(3)]
    n = (probe_ops.batched_probe.launches, commit_ops.fused_commit.launches)
    st, stats = tpcc.run_neworder_rounds(
        cfg, lay, st, oracle, lambda r: _to(no_draws[r], dev), 3,
        engine=engine, device=dev)
    torch.cuda.synchronize()
    assert (probe_ops.batched_probe.launches - n[0],
            commit_ops.fused_commit.launches - n[1]) == (3 * S, 6 * S)
    cpu_st, cpu_stats = tpcc.run_neworder_rounds(
        plain, lay, cpu_st, oracle, lambda r: no_draws[r], 3,
        engine=cpu_engine, device="cpu")
    assert stats.commits == cpu_stats.commits > 0
    assert torch.equal(stats.committed.cpu(), cpu_stats.committed)
    st, mstats = tpcc.run_mixed_rounds(
        cfg, lay, st, oracle, lambda r: _to(mix_draws[r], dev), 3,
        engine=engine, device=dev)
    cpu_st, cpu_mstats = tpcc.run_mixed_rounds(
        plain, lay, cpu_st, oracle, lambda r: mix_draws[r], 3,
        engine=cpu_engine, device="cpu")
    for f in cpu_mstats._fields:
        if f != "local_fraction":
            assert getattr(mstats, f) == getattr(cpu_mstats, f), f
    _assert_leaves_equal(_leaves(cpu_st), _leaves(st),
                         [str(i) for i in range(len(_leaves(st)))])


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if x is None:
        return None
    return type(x)(*(_to(y, device) for y in x))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None:
        return []
    return [leaf for y in x for leaf in _leaves(y)]


# ------------------------------------------------------- LM kernel cases ----
# the sweep shapes of tests/test_kernels.py; inputs are float32 numpy arrays
# made from a seed, rounded to the working dtype by whoever runs them
FLASH_CASES = [  # B, Sq, Sk, Hq, Hkv, D, causal, window, softcap
    (1, 64, 64, 2, 2, 32, True, None, None),
    (2, 100, 100, 4, 2, 32, True, None, None),     # GQA, ragged seq
    (2, 96, 96, 4, 1, 64, True, 33, None),         # MQA + window
    (1, 64, 128, 2, 2, 32, False, None, None),     # cross-attn shape
    (1, 80, 80, 2, 2, 32, True, None, 25.0),       # softcap (gemma2)
]
PAGED_CASES = [(4, 2, 8, None), (8, 8, 16, 9), (4, 1, 8, None)]  # Hq, Hkv,
# ps, window
MOE_CASES = [(2, 16, 16, 32, "silu"), (3, 20, 16, 40, "gelu"),
             (1, 8, 32, 24, "sq_relu")]           # E, C, D, F, activation
MAMBA_CASES = [(2, 40, 24, 8, 8, 8), (1, 64, 16, 16, 16, 16),
               (2, 33, 8, 4, 8, 8)]   # B, S, Di, N, bd, chunk; S=33 ragged
LM_DTYPES = ["float32", "bfloat16"]
# the reference's divergent input for flash: rows 28-39 see no key
NO_KEY_ROWS = (1, 40, 24, 2, 2, 32, True, 5, None)


def flash_inputs(B, Sq, Sk, Hq, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, Hq, D).astype(np.float32),
            rng.randn(B, Sk, Hkv, D).astype(np.float32),
            rng.randn(B, Sk, Hkv, D).astype(np.float32))


def flash_visible_rows(Sq, Sk, causal, window):
    """Query rows that see at least one key."""
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= kp <= qp
    if window is not None:
        vis &= qp - kp < window
    return vis.any(axis=1)


def paged_inputs(Hq, Hkv, ps, seed=1, B=3, D=32, P=40):
    """The sweep's pools and tables: every page below kv_len is mapped."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Hq, D).astype(np.float32)
    kp = rng.randn(P, ps, Hkv, D).astype(np.float32)
    vp = rng.randn(P, ps, Hkv, D).astype(np.float32)
    pt = np.array([[3, 7, 11, -1, -1], [0, 1, 2, 4, 5],
                   [20, 21, -1, -1, -1]], np.int32)
    kv_len = np.array([2 * ps + 3, 5 * ps, ps + 1], np.int32)
    return q, kp, vp, pt, kv_len


def moe_inputs(E, C, D, F, seed=2):
    rng = np.random.RandomState(seed)
    return ((rng.randn(E, C, D) * 0.5).astype(np.float32),
            (rng.randn(E, D, F) * 0.2).astype(np.float32),
            (rng.randn(E, D, F) * 0.2).astype(np.float32),
            (rng.randn(E, F, D) * 0.2).astype(np.float32))


def mamba_inputs(B, S, Di, N, seed=3):
    """dt, x, Bm, Cm (to be rounded to the working dtype) and A_log,
    D_skip (float32), as the reference's sweep draws them."""
    rng = np.random.RandomState(seed)
    dt = np.log1p(np.exp(rng.randn(B, S, Di))).astype(np.float32)
    x = rng.randn(B, S, Di).astype(np.float32)
    Bm = (rng.randn(B, S, N) * 0.3).astype(np.float32)
    Cm = (rng.randn(B, S, N) * 0.3).astype(np.float32)
    A_log = np.log(np.arange(1, N + 1, dtype=np.float32)[None]
                   * (1.0 + 0.1 * np.arange(Di, dtype=np.float32)[:, None]))
    D_skip = np.linspace(0.5, 1.5, Di).astype(np.float32)
    return dt, x, Bm, Cm, A_log.astype(np.float32), D_skip


def _f(a, dtype, dev):
    return torch.from_numpy(a).to(dev).to(getattr(torch, dtype))


def _close(port, plain, tol, what):
    np.testing.assert_allclose(port.float().cpu().numpy(),
                               plain.float().cpu().numpy(), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(case, dtype):
    dev = _cuda()
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap = case
    q, k, v = (_f(a, dtype, dev) for a in flash_inputs(B, Sq, Sk, Hq, Hkv,
                                                         D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    plain = flash_attention_ref(q, k, v, **kw)
    for bq, bk in ((32, 32), (128, 128)):
        out = flash_ops.flash_attention(q, k, v, bq=bq, bk=bk, **kw)
        torch.cuda.synchronize()
        _close(out, plain, LM_TOL[dtype], f"bq={bq} bk={bk}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_flash_kernel_rows_without_keys_on_card(dtype):
    """Sq=40, Sk=24, window 5, causal: rows 28-39 see no key. The kernel
    matches its plain version on rows 0-27 and gives 0 on rows 28-39 (the
    plain version, like the reference, averages every key there)."""
    dev = _cuda()
    B, Sq, Sk, Hq, Hkv, D, causal, window, _ = NO_KEY_ROWS
    q, k, v = (_f(a, dtype, dev) for a in flash_inputs(B, Sq, Sk, Hq, Hkv,
                                                         D))
    seen = flash_visible_rows(Sq, Sk, causal, window)
    assert seen[:28].all() and not seen[28:].any()
    plain = flash_attention_ref(q, k, v, causal=causal, window=window)
    for bq, bk in ((8, 32), (32, 32), (128, 128)):
        out = flash_ops.flash_attention(q, k, v, causal=causal,
                                        window=window, bq=bq, bk=bk)
        torch.cuda.synchronize()
        _close(out[:, seen], plain[:, seen], LM_TOL[dtype], f"bq={bq}")
        assert not out[:, ~seen].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain_on_card(case, dtype):
    dev = _cuda()
    Hq, Hkv, ps, window = case
    q, kp, vp, pt, kl = paged_inputs(Hq, Hkv, ps)
    q, kp, vp = (_f(a, dtype, dev) for a in (q, kp, vp))
    pt, kl = torch.from_numpy(pt).to(dev), torch.from_numpy(kl).to(dev)
    for softcap in (None, 25.0):
        out = paged_ops.paged_attention(q, kp, vp, pt, kl, window=window,
                                        softcap=softcap)
        plain = paged_attention_ref(q, kp, vp, pt, kl, window=window,
                                    softcap=softcap)
        torch.cuda.synchronize()
        _close(out, plain, LM_TOL[dtype], f"softcap={softcap}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_paged_kernel_own_contract_on_card(dtype):
    """By construction: ``kv_len = 0`` gives exactly 0, and a sequence with
    an unmapped page inside ``kv_len`` (no window) equals the plain version
    on the same sequence with that page dropped from its table and
    ``kv_len`` reduced by one page (decode attention does not depend on
    the order of the keys)."""
    dev = _cuda()
    ps = 8
    q, kp, vp, _, _ = paged_inputs(4, 2, ps)
    q, kp, vp = (_f(a, dtype, dev) for a in (q, kp, vp))
    pt = torch.tensor([[3, -1, 7, 11, -1], [0, 1, 2, 4, 5],
                       [20, 21, -1, -1, -1]], dtype=torch.int32, device=dev)
    kl = torch.tensor([3 * ps + 2, 0, ps + 1], dtype=torch.int32,
                      device=dev)
    dropped = torch.tensor([[3, 7, 11, -1, -1], [0, 1, 2, 4, 5],
                            [20, 21, -1, -1, -1]], dtype=torch.int32,
                           device=dev)
    kl_dropped = torch.tensor([2 * ps + 2, 0, ps + 1], dtype=torch.int32,
                              device=dev)
    out = paged_ops.paged_attention(q, kp, vp, pt, kl)
    plain = paged_attention_ref(q, kp, vp, dropped, kl_dropped)
    torch.cuda.synchronize()
    assert not out[1].any()
    _close(out[0::2], plain[0::2], LM_TOL[dtype], "unmapped page dropped")


def paged_partition_case(g, ps, seed=4, Hkv=2, D=32, P=96):
    """Pools of P pages of ps tokens and a table of 4 sequences, 24 pages
    wide, made from a seed: sequence 0 long (22.5 pages), the others short
    (1 token, 1.5 and 3 pages and a token). Every page below kv_len is
    mapped, each sequence to its own pages, so the plain version holds the
    TPU kernel's semantics."""
    rng = np.random.RandomState(seed)
    q = rng.randn(4, Hkv * g, D).astype(np.float32)
    kp = rng.randn(P, ps, Hkv, D).astype(np.float32)
    vp = rng.randn(P, ps, Hkv, D).astype(np.float32)
    pt = rng.permutation(P)[:4 * 24].reshape(4, 24).astype(np.int32)
    kv_len = np.array([22 * ps + ps // 2, 1, ps + ps // 2, 3 * ps + 1],
                      np.int32)
    pt[np.arange(24)[None] * ps >= kv_len[:, None]] = -1
    return q, kp, vp, pt, kv_len


# page sizes whose partitions (paged_ops.default_part: 512 tokens' worth)
# hold one page, two, three (a partition ends mid-tile) and 128, more than
# the table's 24 (one partition a sequence: launch 1 writes the output)
PAGED_PAGE_SIZES = [512, 256, 170, 4]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("g", [1, 2, 8, 12])
def test_paged_kernel_partitions_on_card(g, dtype):
    """One long sequence (23 pages) among short ones, at page sizes that
    give partitions of 1, 2, 3 and 128 pages; g = 12 takes two query
    groups. Without a window, and with a window of 5 pages and a token
    (sequence 0 sees from mid-page 17 on: mid-partition at every size),
    softcap 25 on the second: every page size equals the plain version."""
    dev = _cuda()
    for ps in PAGED_PAGE_SIZES:
        q, kp, vp, pt, kl = paged_partition_case(g, ps)
        q, kp, vp = (_f(a, dtype, dev) for a in (q, kp, vp))
        pt, kl = torch.from_numpy(pt).to(dev), torch.from_numpy(kl).to(dev)
        for kw in (dict(), dict(window=5 * ps + 1, softcap=25.0)):
            out = paged_ops.paged_attention(q, kp, vp, pt, kl, **kw)
            plain = paged_attention_ref(q, kp, vp, pt, kl, **kw)
            torch.cuda.synchronize()
            _close(out, plain, LM_TOL[dtype],
                   f"ps={ps} ({paged_ops.default_part(ps)} pages a "
                   f"partition) {kw}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_paged_kernel_unmapped_page_mid_partition_on_card(dtype):
    """Sequence 0 (23 pages) has page 5 unmapped below kv_len: at 2 pages
    a partition (ps = 256), the second half of partition 2; sequence 3
    (pages 0-3) has pages 2 and 3 unmapped: all of partition 1 there. At
    partitions of 1, 2 and 3 pages each equals the plain version on its
    table with those pages dropped and kv_len reduced to the keys left
    (decode attention does not depend on the order of the keys); the short
    sequences are untouched."""
    dev = _cuda()
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    for ps in PAGED_PAGE_SIZES[:3]:
        q, kp, vp, pt, kl = paged_partition_case(2, ps)
        dropped, kl_dropped = pt.copy(), kl.copy()
        pt[0, 5] = -1
        dropped[0] = np.concatenate([pt[0, :5], pt[0, 6:], [-1]])
        kl_dropped[0] -= ps
        pt[3, 2:4] = -1
        dropped[3, 2:] = -1
        kl_dropped[3] = 2 * ps
        q, kp, vp = (_f(a, dtype, dev) for a in (q, kp, vp))
        out = paged_ops.paged_attention(q, kp, vp, t(pt), t(kl))
        plain = paged_attention_ref(q, kp, vp, t(dropped), t(kl_dropped))
        torch.cuda.synchronize()
        _close(out, plain, LM_TOL[dtype],
               f"ps={ps} ({paged_ops.default_part(ps)} pages a partition)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_kernel_matches_plain_on_card(case, dtype):
    """silu, gelu (tanh) and sq_relu, ragged C and F."""
    dev = _cuda()
    E, C, D, F, act = case
    args = [_f(a, dtype, dev) for a in moe_inputs(E, C, D, F)]
    out = moe_ops.moe_gmm(*args, activation=act)
    plain = moe_gmm_ref(*args, activation=act)
    torch.cuda.synchronize()
    _close(out, plain, LM_TOL[dtype], act)


# the bf16 routes at shapes that cross every tile edge: flash's 128 query
# rows and 64 keys (32 at D = 256), the expert FFN's 128 × 128 tiles and
# 64-deep stages
TC_FLASH_CASES = [(64, None), (64, 50.0), (128, None), (128, 50.0),
                  (256, None), (256, 50.0)]          # D, softcap
TC_MOE_CASE = (3, 200, 136, 264)                     # E, C, D, F


def _held_to_f32_plain(out, plain32, what):
    """|out − plain32| ≤ F32_PLAIN_RTOL·|plain32| + F32_PLAIN_ATOL_RMS ·
    rms(plain32) everywhere, as chip_smoke.py holds full widths."""
    o, p = out.float(), plain32.float()
    lim = F32_PLAIN_RTOL * p.abs() + F32_PLAIN_ATOL_RMS * p.pow(2).mean() \
        .sqrt()
    err = (o - p).abs()
    assert bool(torch.isfinite(o).all()), what
    assert bool((err <= lim).all()), (
        f"{what}: {int((err > lim).sum())} of {err.numel()} outside, max "
        f"abs {float(err.max())}")


@pytest.mark.gpu
@pytest.mark.parametrize("D, softcap", TC_FLASH_CASES)
def test_flash_bf16_route_holds_to_f32_plain_on_card(D, softcap):
    """B = 1, S = 300, Hq = 12 over Hkv = 2, causal with window 100."""
    dev = _cuda()
    q, k, v = (_f(a, "bfloat16", dev)
               for a in flash_inputs(1, 300, 300, 12, 2, D))
    kw = dict(causal=True, window=100, softcap=softcap)
    out = flash_ops.flash_attention(q, k, v, **kw)
    plain32 = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _held_to_f32_plain(out, plain32, f"D={D} softcap={softcap}")


@pytest.mark.gpu
@pytest.mark.parametrize("act", list(moe_ops.ACTIVATIONS))
def test_moe_bf16_route_holds_to_f32_plain_on_card(act):
    dev = _cuda()
    args = [_f(a, "bfloat16", dev) for a in moe_inputs(*TC_MOE_CASE)]
    out = moe_ops.moe_gmm(*args, activation=act)
    plain32 = moe_gmm_ref(*(a.float() for a in args), activation=act)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == args[0].shape
    _held_to_f32_plain(out, plain32, act)


@pytest.mark.gpu
def test_moe_bf16_route_refuses_misaligned_widths_on_card():
    """F = 20 and D = 20 are not multiples of 8: ValueError, no launch;
    the float32 route takes them."""
    dev = _cuda()
    before = moe_ops.moe_gmm.launches
    for E, C, D, F in ((1, 8, 16, 20), (1, 8, 20, 16)):
        args = [_f(a, "bfloat16", dev) for a in moe_inputs(E, C, D, F)]
        with pytest.raises(ValueError, match="multiples of 8"):
            moe_ops.moe_gmm(*args)
    assert moe_ops.moe_gmm.launches == before
    args = [_f(a, "float32", dev) for a in moe_inputs(1, 8, 16, 20)]
    out = moe_ops.moe_gmm(*args)
    torch.cuda.synchronize()
    _close(out, moe_gmm_ref(*args), LM_TOL["float32"], "float32, F = 20")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", MAMBA_CASES)
def test_mamba_kernel_matches_plain_on_card(case, dtype):
    """Including a ragged S (33 steps, chunk 8: the wrapper pads)."""
    dev = _cuda()
    B, S, Di, N, bd, chunk = case
    dt, x, Bm, Cm, A_log, D_skip = mamba_inputs(B, S, Di, N)
    args = [_f(a, dtype, dev) for a in (dt, x, Bm, Cm)] \
        + [torch.from_numpy(A_log).to(dev), torch.from_numpy(D_skip).to(dev)]
    out = mamba_ops.mamba_scan(*args, bd=bd, chunk=chunk)
    plain = mamba_scan_ref(*args)
    torch.cuda.synchronize()
    assert out.shape == (B, S, Di)
    _close(out, plain, MAMBA_TOL[dtype], f"S={S} chunk={chunk}")


# (B, S, Di, N, bd, chunk): 32 and 64 states (the second with S not a
# multiple of the chunk), Di = 40 over blocks of 32 or 16 channels (the last
# partial), B·Di = 8 (one partial block), and Di = 13 with 5 states (the
# wrapper pads channels and states)
MAMBA_EDGE_CASES = [(2, 40, 24, 32, 16, 16), (1, 50, 16, 64, 16, 32),
                    (2, 37, 40, 16, 32, 16), (1, 20, 8, 8, None, 16),
                    (2, 21, 13, 5, None, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", MAMBA_EDGE_CASES)
def test_mamba_kernel_edges_on_card(case, dtype):
    dev = _cuda()
    B, S, Di, N, bd, chunk = case
    dt, x, Bm, Cm, A_log, D_skip = mamba_inputs(B, S, Di, N)
    args = [_f(a, dtype, dev) for a in (dt, x, Bm, Cm)] \
        + [torch.from_numpy(A_log).to(dev), torch.from_numpy(D_skip).to(dev)]
    plain = mamba_scan_ref(*args)
    out = mamba_ops.mamba_scan(*args, bd=bd, chunk=chunk)
    torch.cuda.synchronize()
    assert out.shape == (B, S, Di) and out.dtype == args[1].dtype
    _close(out, plain, MAMBA_TOL[dtype], f"bd={bd} chunk={chunk}")


# (B, S, Di, N): chip_smoke's S1 (jamba-v0.1 width, B 2, S 4,096) and
# jamba's prefill on its path (B 4, S 1,000: not a multiple of the chunk)
MAMBA_STATE_CASES = [(2, 4096, 8192, 16), (4, 1000, 8192, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", MAMBA_STATE_CASES)
def test_mamba_kernel_last_state_on_card(case, dtype):
    """``return_state``: one launch; its y is the default call's, bit for
    bit; y and the float32 last state held to the plain version (the
    kernel takes dt·x in float32 where the plain version rounds it to the
    inputs' dtype, so the state is held at the dtype's tolerance)."""
    dev = _cuda()
    dt, x, Bm, Cm, A_log, D_skip = mamba_inputs(*case)
    args = [_f(a, dtype, dev) for a in (dt, x, Bm, Cm)] \
        + [torch.from_numpy(A_log).to(dev), torch.from_numpy(D_skip).to(dev)]
    before = mamba_ops.mamba_scan.launches
    y, h_last = mamba_ops.mamba_scan(*args, return_state=True)
    assert mamba_ops.mamba_scan.launches == before + 1
    y0 = mamba_ops.mamba_scan(*args)
    plain, h_plain = mamba_scan_ref(*args, return_state=True)
    torch.cuda.synchronize()
    B, S, Di, N = case
    assert h_last.shape == (B, Di, N) and h_last.dtype == torch.float32
    assert torch.equal(y, y0)
    _close(y, plain, MAMBA_TOL[dtype], f"y, S={S}")
    _close(h_last, h_plain, MAMBA_TOL[dtype], f"h_last, S={S}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_apply_mamba_kernel_matches_plain_on_card(dtype):
    """A mamba layer's prefill through the kernel (its float32 route)
    against ``kernels=False`` on the same weights: y in the model's dtype,
    the conv state bit for bit, the SSM state within float32's tolerance;
    decode from either cache runs plain (no launch)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    p = recurrent.Mamba(256, dtype=getattr(torch, dtype), device=dev,
                        generator=gen)
    x = torch.randn(2, 100, 256, generator=gen, device=dev) \
        .to(getattr(torch, dtype))
    with torch.no_grad():
        before = mamba_ops.mamba_scan.launches
        yk, ck = recurrent.apply_mamba(p, x)
        assert mamba_ops.mamba_scan.launches == before + 1
        yp, cp = recurrent.apply_mamba(p, x, kernels=False)
        x1 = x[:, :1]
        zk, dk = recurrent.apply_mamba(p, x1, ck)
        zp, dp = recurrent.apply_mamba(p, x1, cp)
        assert mamba_ops.mamba_scan.launches == before + 1
    torch.cuda.synchronize()
    assert yk.dtype == x.dtype and ck.ssm.dtype == torch.float32
    tol = MAMBA_TOL[dtype]
    _close(yk, yp, tol, "prefill y")
    assert torch.equal(ck.conv, cp.conv)
    _close(ck.ssm, cp.ssm, MAMBA_TOL["float32"], "prefill ssm state")
    _close(zk, zp, tol, "decode y")
    _close(dk.ssm, dp.ssm, MAMBA_TOL["float32"], "decode ssm state")


@pytest.mark.gpu
def test_lm_empty_calls_launch_nothing_and_count_nothing():
    dev = _cuda()
    wrappers = (flash_ops.flash_attention, paged_ops.paged_attention,
                moe_ops.moe_gmm, mamba_ops.mamba_scan)
    before = [w.launches for w in wrappers]
    e = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    assert flash_ops.flash_attention(e(0, 8, 2, 32), e(0, 8, 2, 32),
                                     e(0, 8, 2, 32)).shape == (0, 8, 2, 32)
    i32 = dict(dtype=torch.int32, device=dev)
    assert paged_ops.paged_attention(
        e(0, 4, 32), e(4, 8, 2, 32), e(4, 8, 2, 32),
        torch.zeros((0, 2), **i32), torch.zeros((0,), **i32)).shape \
        == (0, 4, 32)
    assert moe_ops.moe_gmm(e(2, 0, 16), e(2, 16, 8), e(2, 16, 8),
                           e(2, 8, 16)).shape == (2, 0, 16)
    assert mamba_ops.mamba_scan(e(1, 0, 8), e(1, 0, 8), e(1, 0, 4),
                                e(1, 0, 4), e(8, 4), e(8)).shape == (1, 0, 8)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == before


@pytest.mark.gpu
def test_lm_wrappers_raise_on_bad_cuda_inputs():
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev)
               for a in flash_inputs(1, 8, 8, 2, 2, 32))
    with pytest.raises(ValueError):                # float16 is not taken
        flash_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):                # not contiguous
        flash_ops.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):                # k on another device
        flash_ops.flash_attention(q, k.cpu(), v)
    x, wg, wi, wo = (torch.from_numpy(a).to(dev)
                     for a in moe_inputs(1, 8, 16, 8))
    with pytest.raises(ValueError):
        moe_ops.moe_gmm(x, wg.bfloat16(), wi, wo)


@pytest.mark.gpu
def test_lm_wrappers_refuse_a_gradient_on_card():
    """Each LM kernel wrapper raises, naming the plain path, when
    autograd is on and an input requires a gradient, and launches
    nothing; under ``torch.no_grad()`` the same call launches."""
    dev = _cuda()
    q, k, v = (torch.from_numpy(a).to(dev)
               for a in flash_inputs(1, 8, 8, 2, 2, 32))
    x, wg, wi, wo = (torch.from_numpy(a).to(dev)
                     for a in moe_inputs(1, 8, 16, 8))
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    calls = {
        flash_ops.flash_attention: lambda w: flash_ops.flash_attention(
            w(q), k, v),
        moe_ops.moe_gmm: lambda w: moe_ops.moe_gmm(x, w(wg), wi, wo),
        mamba_ops.mamba_scan: lambda w: mamba_ops.mamba_scan(
            torch.rand(1, 8, 16, **f32), w(torch.randn(1, 8, 16, **f32)),
            torch.randn(1, 8, 4, **f32), torch.randn(1, 8, 4, **f32),
            torch.zeros(16, 4, **f32), torch.ones(16, **f32)),
        paged_ops.paged_attention: lambda w: paged_ops.paged_attention(
            w(torch.randn(1, 4, 32, **f32)), torch.randn(2, 8, 2, 32, **f32),
            torch.randn(2, 8, 2, 32, **f32), torch.zeros((1, 2), **i32),
            torch.full((1,), 8, **i32)),
    }
    for wrapper, call in calls.items():
        n = wrapper.launches
        with pytest.raises(RuntimeError, match="no gradient.*plain path"):
            call(lambda t: t.clone().requires_grad_(True))
        assert wrapper.launches == n, wrapper.__name__
        with torch.no_grad():
            call(lambda t: t.clone().requires_grad_(True))
        torch.cuda.synchronize()
        assert wrapper.launches == n + 1, wrapper.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("aid", ["mixtral-8x22b", "jamba-v0.1-52b",
                                 "whisper-medium"])
def test_bf16_train_step_launches_no_kernel_on_card(aid):
    """A bf16 train step at a small width (``reduced``) on the card runs
    the plain path: no LM kernel launches, the loss and gradient norm are
    finite and every parameter moves; the same batch's loss equals the
    plain ``kernels=False`` forward's under ``no_grad``."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainstep import make_train_step
    dev = _cuda()
    cfg = reduced(get_arch(aid))
    m = api.build(cfg)
    model = m.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4), 0, arch=cfg, device=dev)
    wrappers = (flash_ops.flash_attention, paged_ops.paged_attention,
                moe_ops.moe_gmm, mamba_ops.mamba_scan)
    before = [w.launches for w in wrappers]
    with torch.no_grad():
        want = m.train_loss(model, batch)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(m, opt.AdamWConfig(warmup_steps=1), 2)
    model, state, met = step(model, opt.init(model), batch)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == before
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    torch.testing.assert_close(met["loss"], want, rtol=2e-2, atol=0)
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), old[n])]
    assert len(moved) == len(old)


# ------------------------------------------------- the timestamp oracles ----
def shared_slot_commit_case(seed, near_wrap):
    """``commit_many_case`` cut to 60 transactions of 16 requests whose
    make-visible shares ONE vector slot (one compute server of 60 threads,
    the compressed oracle's): distinct commit timestamps above the slot,
    some past 2^31 or wrapping past 2^32 with ``near_wrap``, so the
    kernel's atomic max must compare them as unsigned words."""
    tbl, args = commit_many_case(seed, R=1 << 14, T=60, WS=16)
    rng = np.random.RandomState(seed + 100)
    base = np.uint32(0xFFFFFFE0 if near_wrap else 1000)
    vec = np.array([base], np.uint32)
    cts = (base + np.uint32(1) + rng.permutation(60).astype(np.uint32))
    txn_slot = np.zeros(60, np.int32)
    new_hdr = args[6].copy()
    new_hdr[:, 1] = np.repeat(cts, 16)
    new_hdr[:, 0] = 0
    return tbl, (vec,) + args[1:6] + (new_hdr,) + args[7:9] + (
        txn_slot, cts, args[11])


@pytest.mark.gpu
@pytest.mark.parametrize("near_wrap", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_commit_shared_vector_slot_on_card(seed, near_wrap):
    """60 lanes of transactions share one make-visible slot: the kernel's
    in-launch scatter-max equals the plain twin's, vector included."""
    dev = _cuda()
    case = shared_slot_commit_case(seed, near_wrap)
    ker = port_commit(commit_ops.fused_commit, case, dev)
    torch.cuda.synchronize()
    plain = port_commit(fused_commit_ref, case)
    _assert_leaves_equal(plain, ker, COMMIT_OUT)
    committed = plain[10].numpy()
    assert committed.sum() > 1      # several committers share the slot
    assert np_to_i32(np.array([max(case[1][10][committed])],
                              np.uint32))[0] == int(plain[8][0])


def si_batch(rng, n_records, T, rs, ws):
    """``tests/_si_common.gen_batch`` in numpy and torch: distinct read
    slots a transaction, write refs into its own read set, every written
    ref a masked read."""
    slots = np.stack([rng.choice(n_records, size=rs, replace=False)
                      for _ in range(T)])
    read_mask = rng.random((T, rs)) < 0.9
    wref = np.stack([rng.choice(rs, size=ws, replace=False)
                     for _ in range(T)])
    write_mask = rng.random((T, ws)) < 0.7
    for t in range(T):
        read_mask[t, wref[t][write_mask[t]]] = True
    return tsi.TxnBatch(
        tid=torch.arange(T, dtype=torch.int32),
        read_slots=torch.from_numpy(slots.astype(np.int32)),
        read_mask=torch.from_numpy(read_mask),
        write_ref=torch.from_numpy(wref.astype(np.int32)),
        write_mask=torch.from_numpy(write_mask))


def si_compute(batch):
    def fn(rh, rd, vec):
        wref = batch.write_ref.clamp(0, rd.shape[1] - 1).long()
        base = rd.gather(1, wref[:, :, None].expand(-1, -1, rd.shape[2]))
        return base + (batch.tid + 1)[:, None, None]
    return fn


SI_ORACLES = {
    "naive": lambda: tts.NaiveOracleAdapter(60, capacity=256),
    "compressed_one_slot": lambda: tts.CompressedVectorOracle(60, 60),
    "compressed_x15": lambda: tts.CompressedVectorOracle(60, 15),
    "vector": lambda: VectorOracle(60),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SI_ORACLES))
def test_oracle_rounds_kernels_match_plain_path_on_card(name):
    """Six ``si.run_round`` rounds of 60 threads through both kernels on
    the card equal the plain path on the CPU: outcomes, the table and the
    whole oracle state. The naive adapter's kernel call writes a scratch
    vector (its own make-visible runs after it), so its ``state.vec`` is
    the plain round's; the one-slot compressed oracle's 60 threads share
    the kernel's make-visible slot (the capacity of 256 stalls the naive
    adapter's read timestamp in the fifth round)."""
    dev = _cuda()
    oracle = SI_ORACLES[name]()
    rng = np.random.default_rng(4)
    cpu_tab = tmvcc.init_table(512, 4, n_old=4, n_overflow=4, device="cpu")
    tab = _copy(cpu_tab, dev)
    cpu_state = oracle.init(device="cpu")
    state = _copy(cpu_state, dev)
    for r in range(6):
        b = si_batch(rng, 512, 60, 8, 4)
        n = (probe_ops.batched_probe.launches,
             commit_ops.fused_commit.launches)
        out = tsi.run_round(tab, oracle, state, _to(b, dev),
                            si_compute(_to(b, dev)), fused_commit=True,
                            batched_probe=True)
        assert (probe_ops.batched_probe.launches - n[0],
                commit_ops.fused_commit.launches - n[1]) == (1, 1)
        ref = tsi.run_round(cpu_tab, oracle, cpu_state, b, si_compute(b))
        for f in ("committed", "snapshot_miss", "read_data"):
            assert torch.equal(getattr(out, f).cpu(), getattr(ref, f)), \
                (r, f)
        _assert_leaves_equal(_leaves(ref.oracle_state),
                             _leaves(out.oracle_state),
                             [f"round {r} oracle state"] * 8)
        tmvcc.version_mover(tab)
        tmvcc.version_mover(cpu_tab)
    _assert_leaves_equal(_leaves(cpu_tab), _leaves(tab),
                         tmvcc.VersionedTable._fields)


def _copy(x, device):
    """A copy of a tensor or a (nested) tuple of them on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return type(x)(*(_copy(y, device) for y in x))


@pytest.mark.gpu
def test_oracle_functions_on_card_match_cpu():
    """Every new oracle function on CUDA tensors equals the same call on
    the CPU, on the wrap cases of ``tests/test_torch_oracle.py`` (states
    updated in place: each side gets its own copy)."""
    dev = _cuda()
    rng = np.random.RandomState(8)

    def both(label, fn, *xs):
        a = fn(*(_copy(x, "cpu") for x in xs))
        b = fn(*(_copy(x, dev) for x in xs))
        _assert_leaves_equal(_leaves(a), _leaves(b), [label] * 8)

    g = tts.GlobalCounterOracle(64)
    bitmap = (rng.rand(64) < 0.7).astype(np.uint32)
    bitmap[:10] = 1
    gs = tts.GlobalCounterState(
        _t(np.array([0xFFFFFFFB], np.uint32)), _t(np.array([9], np.uint32)),
        _t(bitmap), _t(np.array([0xFFFFFFF4], np.uint32)))
    cts = _t(np.array([0xFFFFFFFC, 0xFFFFFFFF, 0, 3, 70, 5, 200, 0x80000000],
                      np.uint32))
    both("fetch_commit_ts", lambda s: g.fetch_commit_ts(s, 8), gs)
    both("complete", g.complete, gs, cts)
    both("advance", g.advance, gs)
    both("read", g.read, gs)
    c = tts.CompressedVectorOracle(10, 4)
    vs = tts.VectorState(_t(np.array([0xFFFFFFFF, 7], np.uint32)))
    tids = torch.tensor([0, 3, 8, 9, 12, -1, -9, 5], dtype=torch.int32)
    want = torch.from_numpy(rng.rand(8) < 0.6)
    both("next_commit_ts_batch", c.next_commit_ts_batch, vs, tids, want)
    both("next_commit_ts_batch, none want", c.next_commit_ts_batch, vs, tids,
         torch.zeros(8, dtype=torch.bool))
    both("next_commit_ts", c.next_commit_ts, vs, tids)
    both("make_visible", c.make_visible, vs, tids, cts, want)
    nv = tts.NaiveOracleAdapter(16, capacity=32)
    ns = nv.init(device="cpu")
    ns.gc.cts.fill_(-20)
    t16 = torch.arange(16, dtype=torch.int32)
    both("naive next_commit_ts_batch", nv.next_commit_ts_batch, ns, t16,
         torch.ones(16, dtype=torch.bool))
    both("naive make_visible", nv.make_visible, ns, t16, t16 * 7 - 30)
    hist = _t(rng.randint(0, 1 << 32, (3, 4)).astype(np.uint32))
    both("staleness_window", lambda h: tts.staleness_window(h, 2), hist)
    assert tts.snapshot_summary(hist.to(dev)) == tts.snapshot_summary(hist)
    granted = torch.from_numpy(rng.rand(40) < 0.7)
    active = torch.from_numpy(rng.rand(40) < 0.8)
    txn = torch.from_numpy(rng.randint(-2, 8, 40).astype(np.int32))
    both("all_granted_per_txn",
         lambda g_, t, a: tcas.all_granted_per_txn(g_, t, 6, a),
         granted, txn, active)
    both("key64", theader.key64,
         _t(rng.randint(0, 1 << 32, (5, 2)).astype(np.uint32)))


# ------------------------------------------------------ the serve path ----
def _serve_model(aid, dev, seed=0, **kw):
    """A reduced configuration in bf16 with weights drawn on the card."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_arch(aid)), **kw)
    return cfg, transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)


def _serve_prompts(seed, n, vocab, lens=(4, 20)):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, rng.randint(lens[0], lens[1] + 1))
            .astype(np.int32) for _ in range(n)]


def _serve_int_state(st):
    return [st.meta.hdr, st.meta.refcount, st.table.page_table,
            st.table.kv_len, st.table.active, st.done, st.epoch]


def _logits_close(lk, lp, rows, limit=0.05):
    """Relative RMS of the logits' difference over ``rows`` within
    ``limit``; greedy tokens equal where the plain margin exceeds four times
    the row's max |difference|."""
    a, b = lk[rows].float(), lp[rows].float()
    d = a - b
    assert float(d.pow(2).mean().sqrt() / b.pow(2).mean().sqrt()) <= limit
    top2 = b.topk(2, dim=-1).values
    tested = (top2[:, 0] - top2[:, 1]) > 4 * d.abs().amax(dim=-1)
    assert bool(((a.argmax(-1) == b.argmax(-1)) | ~tested).all())


@pytest.mark.gpu
@pytest.mark.parametrize("aid", ["granite-3-8b", "gemma2-27b"])
def test_engine_kernel_path_matches_plain_path_on_card(aid):
    """Two waves of 12 requests through the engine with the kernels and
    through its plain path in lockstep, the plain path's tokens and done
    flags copied into the kernel path's state after every admission and
    step: the integer state is equal throughout, the logits within a
    relative RMS of 0.05, and the kernels launch once a layer for every
    admission (flash) and every step with a lane in the paged kernel's
    contract."""
    dev = _cuda()
    cfg, model = _serve_model(aid, dev)
    ecfg = engine.EngineConfig(max_seqs=8, page_size=16, n_pages=64,
                               max_len=64)
    ke = engine.Engine(cfg, model, ecfg, kernels=True)
    pe = engine.Engine(cfg, model, ecfg, kernels=False)
    ks, ps = ke.init_state(), pe.init_state()
    flash0 = flash_ops.flash_attention.launches
    paged0 = paged_ops.paged_attention.launches
    admits = kernel_steps = 0
    prompts = _serve_prompts(1, 12, cfg.vocab)
    for wave in (prompts[:8], prompts[8:]):
        ks, lk, sid = ke.admit_logits(ks, wave)
        ps, lp, _ = pe.admit_logits(ps, wave)
        _logits_close(lk, lp, list(range(len(wave))))
        ps = pe.sample_first(ps, lp, sid)
        ks = ke.sample_first(ks, lk, sid)._replace(tokens=ps.tokens.clone(),
                                                  done=ps.done.clone())
        admits += 1
        for _ in range(5):
            ks, lk = ke.decode_logits(ks)
            ps, lp = pe.decode_logits(ps)
            live = (ps.table.active & ~ps.done).nonzero()[:, 0].tolist()
            _logits_close(lk, lp, live)
            kernel_steps += any(len(g) for g, _ in ke.last_split.values())
            ks, ps = ke.sample(ks, lk), pe.sample(ps, lp)
            ks = ks._replace(tokens=ps.tokens.clone(), done=ps.done.clone())
            for a, b in zip(_serve_int_state(ks), _serve_int_state(ps)):
                assert torch.equal(a, b)
        ks = ke.release_finished(ks._replace(done=ks.done | ks.table.active))
        ps = pe.release_finished(ps._replace(done=ps.done | ps.table.active))
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches - flash0 \
        == cfg.n_layers * admits
    assert paged_ops.paged_attention.launches - paged0 \
        == cfg.n_layers * kernel_steps
    assert kernel_steps == 10     # wave 2 has kernel lanes beside others


@pytest.mark.gpu
def test_engine_contract_lanes_beside_active_lanes_on_card(monkeypatch):
    """A MoE config whose decode capacity overflows (8 experts, top-2, 8
    lanes: 4 rows an expert; a zero router ties every expert, so every
    token takes experts 0 and 1): a lane finished at a page boundary and
    five slots never admitted go through the plain sub-batch, the two
    active lanes through the paged kernel. Every lane's expert choices are
    the plain path's, so the overflow drops the same choices, and the
    active lanes' logits agree with the plain path's."""
    dev = _cuda()
    cfg, model = _serve_model("mixtral-8x22b", dev, n_experts=8)
    with torch.no_grad():
        for layer in model.layers:
            layer.moe.router.zero_()
    ecfg = engine.EngineConfig(max_seqs=8, page_size=16, n_pages=64,
                               max_len=64)
    ke = engine.Engine(cfg, model, ecfg, kernels=True)
    pe = engine.Engine(cfg, model, ecfg, kernels=False)
    prompts = [p for p in _serve_prompts(2, 3, cfg.vocab)]
    prompts[1] = np.arange(2, 18, dtype=np.int32)   # 16 tokens: one page
    st = pe.admit(pe.init_state(), prompts)
    st = st._replace(done=torch.tensor([False, True] + [True] * 6,
                                       device=dev))
    routes = {}
    orig = moe.top_k_choices

    def record(probs, k):
        out = orig(probs, k)
        routes.setdefault(record.tag, []).append(out[1])
        return out
    monkeypatch.setattr(moe, "top_k_choices", record)
    record.tag = "k"
    paged0 = paged_ops.paged_attention.launches
    moe0 = moe_ops.moe_gmm.launches
    _, lk = ke.decode_logits(st)
    record.tag = "p"
    _, lp = pe.decode_logits(st)
    torch.cuda.synchronize()
    good, bad = ke.last_split[cfg.sliding_window]
    assert list(good) == [0, 2] and list(bad) == [1, 3, 4, 5, 6, 7]
    assert paged_ops.paged_attention.launches - paged0 == cfg.n_layers
    assert moe_ops.moe_gmm.launches - moe0 == cfg.n_layers
    for a, b in zip(routes["k"], routes["p"]):
        assert torch.equal(a, b)
    idx = routes["p"][0].reshape(-1)
    assert int((idx == 0).sum()) > 4          # expert 0 overflows
    _logits_close(lk, lp, [0, 2])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_moe_gmm_kernel_at_decode_capacity_on_card(dtype):
    """C = 4 rows an expert (8 tokens, top-2, 8 experts, capacity factor
    2), some buckets empty as routing leaves them."""
    dev = _cuda()
    rng = np.random.RandomState(3)
    E, C, D, F = 8, 4, 128, 256
    x = rng.randn(E, C, D).astype(np.float32)
    x[3:5] = 0.0
    ws = [rng.randn(*s).astype(np.float32) * s[1] ** -0.5
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    x, wg, wi, wo = (_f(a, dtype, dev) for a in (x, *ws))
    out = moe_ops.moe_gmm(x, wg, wi, wo)
    plain = moe_gmm_ref(x, wg, wi, wo)
    torch.cuda.synchronize()
    _close(out, plain, LM_TOL[dtype], "C = 4")
    assert not out[3:5].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_paged_kernel_over_a_table_after_release_on_card(dtype):
    """Pages allocated, released and allocated again (``kvcache``): after
    a release, a sequence's next pages and a new sequence's come from the
    freed ids, so the tables hold page ids in no order; the kernel equals
    its plain version on them."""
    dev = _cuda()
    ps, Hq, Hkv, D = 4, 4, 2, 32
    meta = kvc.init_meta(40, dev)
    table = kvc.init_seq_table(4, 12, dev)

    def alloc(meta, table, seq, want, start, epoch):
        seq = torch.tensor(seq, dtype=torch.int32, device=dev)
        meta, pages, ok = kvc.alloc_pages(
            meta, torch.tensor(want, dtype=torch.int32, device=dev), seq,
            torch.tensor(epoch, dtype=torch.int32, device=dev))
        assert bool(ok.all())
        return meta, kvc.map_pages(table, seq, pages, torch.tensor(
            start, dtype=torch.int32, device=dev))
    meta, table = alloc(meta, table, [0, 1, 2, 3], [5, 9, 3, 7],
                        [0, 0, 0, 0], 1)
    meta, table = kvc.release_seqs(meta, table, torch.tensor(
        [0, 3], dtype=torch.int32, device=dev))
    meta, table = alloc(meta, table, [2], [2], [3], 2)     # pages 0, 1
    meta, table = alloc(meta, table, [0, 3], [8, 3], [0, 0], 3)
    pt = table.page_table
    assert pt[2, :5].tolist() == [14, 15, 16, 0, 1]
    assert pt[0, :8].tolist() == [2, 3, 4, 17, 18, 19, 20, 21]
    kv_len = torch.tensor([30, 36, 18, 11], dtype=torch.int32, device=dev)
    rng = np.random.RandomState(5)
    q = _f(rng.randn(4, Hq, D).astype(np.float32), dtype, dev)
    kp = _f(rng.randn(41, ps, Hkv, D).astype(np.float32), dtype, dev)
    vp = _f(rng.randn(41, ps, Hkv, D).astype(np.float32), dtype, dev)
    for window in (None, 9):
        out = paged_ops.paged_attention(q, kp, vp, pt, kv_len, window=window)
        plain = paged_attention_ref(q, kp, vp, pt, kv_len, window=window)
        torch.cuda.synchronize()
        _close(out, plain, LM_TOL[dtype], f"window {window}")


@pytest.mark.gpu
def test_missing_kernel_library_raises_on_the_serve_path(monkeypatch):
    """With no library loaded and none to be built, the wrappers and the
    model's path on the card raise; nothing falls back to the plain
    version."""
    dev = _cuda()
    cfg, model = _serve_model("mixtral-8x22b", dev)

    def no_build(names=_build.KERNELS):
        raise RuntimeError("no kernel library")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build_all", no_build)
    tok = torch.randint(2, cfg.vocab, (2, 8), device=dev)
    with pytest.raises(RuntimeError, match="no kernel library"), \
            torch.no_grad():
        transformer.forward_hidden(cfg, model, tok)
    x = torch.zeros(4, 2, 128, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(4, 128, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(RuntimeError, match="no kernel library"):
        moe_ops.moe_gmm(x, w, w, w.transpose(1, 2).contiguous())
    eng = engine.Engine(cfg, model, engine.EngineConfig(n_pages=32,
                                                        max_len=64))
    with pytest.raises(RuntimeError, match="no kernel library"):
        eng.admit(eng.init_state(), _serve_prompts(3, 2, cfg.vocab))
    plain = engine.Engine(cfg, model, engine.EngineConfig(n_pages=32,
                                                          max_len=64),
                          kernels=False)
    st = plain.admit(plain.init_state(), _serve_prompts(3, 2, cfg.vocab))
    with pytest.raises(RuntimeError, match="no kernel library"):
        eng.decode_step(st)


# ------------------------------------ the encoder-decoder and prefix-LM ----
# flash attention at the shapes of whisper-medium and paligemma-3b (two
# rows): B, Sq, Sk, Hq, Hkv, D, causal
ENCDEC_FLASH_CASES = {
    "whisper_encoder": (2, 1500, 1500, 16, 16, 64, False),
    "whisper_cross_decode": (2, 1, 1500, 16, 16, 64, False),
    "paligemma_prefix_block": (2, 256, 256, 8, 1, 256, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", list(ENCDEC_FLASH_CASES))
def test_flash_kernel_at_encdec_shapes_on_card(case, dtype):
    """Non-causal attention over whisper's 1,500 frames (every query row,
    and one query row as a decode step's cross-attention asks) and over
    paligemma's 256-patch prefix (8 query heads over one KV head, D =
    256): one launch, held against the plain version (and, in bf16, the
    plain version on float32 copies)."""
    dev = _cuda()
    B, Sq, Sk, Hq, Hkv, D, causal = ENCDEC_FLASH_CASES[case]
    q, k, v = (_f(a, dtype, dev) for a in flash_inputs(B, Sq, Sk, Hq, Hkv,
                                                         D))
    before = flash_ops.flash_attention.launches
    out = flash_ops.flash_attention(q, k, v, causal=causal)
    assert flash_ops.flash_attention.launches == before + 1
    plain = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(out, plain, LM_TOL[dtype], case)
    if dtype == "bfloat16":
        _held_to_f32_plain(out, flash_attention_ref(
            q.float(), k.float(), v.float(), causal=causal), case)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("P", [1, 100, 256, 300])
def test_prefix_attention_on_card_matches_plain(P, dtype):
    """The prefix-LM mask as two launches of the kernel (causal over all
    288 rows, non-causal over the first P) against the same composition
    of the plain versions and against ``chunked_attention`` with
    ``prefix_len`` P; P = 300 passes the sequence (one launch's rows
    overwritten whole)."""
    dev = _cuda()
    B, S, Hq, Hkv, D = 2, 288, 8, 1, 128
    q, k, v = (_f(a, dtype, dev) for a in flash_inputs(B, S, S, Hq, Hkv, D))
    before = flash_ops.flash_attention.launches
    out = blocks.prefix_attention(q, k, v, P)
    assert flash_ops.flash_attention.launches == before + 2
    plain = blocks.prefix_attention(q, k, v, P, attend=flash_attention_ref)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    masked = common.chunked_attention(
        q, k, v, positions_q=pos, positions_k=pos, causal=True,
        prefix_len=torch.full((B,), P, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    _close(out, plain, LM_TOL[dtype], f"P={P} against the composition")
    _close(out, masked, LM_TOL[dtype], f"P={P} against the mask")


def _encdec_batch(cfg, dev, dtype, B=2, S=6, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(2, cfg.vocab, (B, S), generator=gen,
                                     device=dev, dtype=torch.int32)}
    for name, n, on in (("frames", cfg.encoder_seq, cfg.is_encdec),
                        ("patches", cfg.prefix_len, cfg.is_prefix_lm)):
        if on:
            batch[name] = (0.1 * torch.randn(B, n, cfg.d_model,
                                             generator=gen, device=dev)) \
                .to(dtype)
    return batch


def _rel_rms(a, b):
    d = a.float() - b.float()
    return float(d.pow(2).mean().sqrt() / b.float().pow(2).mean().sqrt())


@pytest.mark.gpu
@pytest.mark.parametrize("aid", ["whisper-medium", "paligemma-3b"])
def test_encdec_model_kernel_path_matches_plain_on_card(aid):
    """Reduced whisper (2 encoder layers over 16 frames) and
    paligemma (8 patches) in bf16 through ``Model.prefill`` and 4
    ``decode_step`` s with the kernels against ``kernels=False``, both on
    the plain path's greedy tokens: ``flash_attention`` launches per
    encoder layer, decoder self-attention and cross-attention a prefill
    and per cross-attention a step (whisper), or twice a layer a prefill
    and never a step (paligemma); the hidden state, every layer's K/V,
    ``enc_kv`` and the logits within a relative RMS of 0.05, ``kv_len``
    equal."""
    dev = _cuda()
    cfg, model = _serve_model(aid, dev)
    m = api.build(cfg)
    batch = _encdec_batch(cfg, dev, model.embed.dtype)
    L = cfg.n_layers
    pre, step = (cfg.encoder_layers + 2 * L, L) if cfg.is_encdec \
        else (2 * L, 0)
    with torch.no_grad():
        before = flash_ops.flash_attention.launches
        hk, ck = m.prefill(model, batch, 16)
        assert flash_ops.flash_attention.launches == before + pre
        hp, cp = m.prefill(model, batch, 16, kernels=False)
        assert flash_ops.flash_attention.launches == before + pre
        assert _rel_rms(hk, hp) <= 0.05
        for a, b in zip(ck.enc_kv, cp.enc_kv):
            assert _rel_rms(a, b) <= 0.05
        tok = transformer.lm_head(hp, model.embed, cfg.logit_softcap) \
            .argmax(-1).to(torch.int32)
        for _ in range(4):
            before = flash_ops.flash_attention.launches
            lk, ck = m.decode_step(model, ck, tok)
            assert flash_ops.flash_attention.launches == before + step
            lp, cp = m.decode_step(model, cp, tok, kernels=False)
            assert torch.equal(ck.kv_len, cp.kv_len)
            _logits_close(lk, lp, list(range(lk.shape[0])))
            for sk, sp in zip(ck.slots, cp.slots):
                assert _rel_rms(sk.k, sp.k) <= 0.05
                assert _rel_rms(sk.v, sp.v) <= 0.05
            tok = lp.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()


def _sharded_moe(dev, dtype, T=256, D=64, F=128, E=4):
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init_moe(D, F, E, dtype, device=dev, generator=gen)
    x = torch.randn(T, D, generator=gen, device=dev).to(dtype)
    return p, x


def _moe_under(mesh_shape, p, x, cf, kernels=True):
    """``apply_moe`` under the opt policy and a shape-only mesh (None: the
    global dispatch), and the ``moe_gmm`` launches it made."""
    from repro_torch import policy
    from repro_torch.launch.mesh import Mesh
    prev = policy.current()
    policy.set_policy("opt")
    before = moe_ops.moe_gmm.launches
    try:
        with torch.no_grad():
            if mesh_shape is None:
                out = moe.apply_moe(p, x, top_k=2, capacity_factor=cf,
                                    kernels=kernels)
            else:
                with Mesh(("data", "model"), mesh_shape):
                    out = moe.apply_moe(p, x, top_k=2, capacity_factor=cf,
                                        kernels=kernels)
        torch.cuda.synchronize()
    finally:
        policy.set_policy(prev)
    return out, moe_ops.moe_gmm.launches - before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sharded_moe_dispatch_bit_identical_to_global_on_card(dtype):
    """At a dropless capacity the (4, 1) mesh's dispatch, its 4 shards'
    buckets in one ``moe_gmm`` launch, equals the global dispatch's kernel
    path bit for bit: each row of the grouped FFN is independent of its
    position."""
    dev = _cuda()
    p, x = _sharded_moe(dev, dtype)
    (yg, sg), ng = _moe_under(None, p, x, 2.0)
    (ys, ss), ns = _moe_under((4, 1), p, x, 2.0)
    assert ng == ns == 1
    assert torch.equal(ys, yg)
    assert torch.equal(ss.load, sg.load)
    assert float(ss.dropped_fraction) == float(sg.dropped_fraction) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_sharded_moe_dispatch_one_launch_a_model_slice_on_card(mesh_shape):
    """At a capacity that drops, the sharded kernel path launches
    ``moe_gmm`` once a model slice and matches its plain path: routing
    and drops exactly, y within the bf16 tolerance."""
    dev = _cuda()
    p, x = _sharded_moe(dev, torch.bfloat16)
    (yk, sk), nk = _moe_under(mesh_shape, p, x, 0.75)
    (yp, sp), npl = _moe_under(mesh_shape, p, x, 0.75, kernels=False)
    assert (nk, npl) == (mesh_shape[1], 0)
    assert torch.equal(sk.load, sp.load)
    assert float(sk.dropped_fraction) == float(sp.dropped_fraction) > 0
    tol = LM_TOL["bfloat16"]
    _close(yk, yp, tol, f"sharded {mesh_shape}")


@pytest.mark.gpu
def test_sharded_moe_dispatch_refuses_a_gradient_on_card():
    dev = _cuda()
    p, x = _sharded_moe(dev, torch.bfloat16)
    from repro_torch import policy
    from repro_torch.launch.mesh import Mesh
    prev = policy.current()
    policy.set_policy("opt")
    before = moe_ops.moe_gmm.launches
    try:
        with Mesh(("data", "model"), (4, 1)), \
                pytest.raises(RuntimeError, match="no gradient"):
            moe.apply_moe(p, x, top_k=2)
    finally:
        policy.set_policy(prev)
    assert moe_ops.moe_gmm.launches == before


# ------------------------------------------- the analyzer's card checks ----
@pytest.mark.gpu
def test_k3_built_functions_fit_the_card():
    """Every design point's function: static plus dynamic shared memory
    within the card's opt-in limit (which is ``MAX_SMEM``), registers times
    threads within an SM's register file."""
    from repro_torch.analysis import kernel_audit
    _cuda()
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert optin == MAX_SMEM
    _build.build_all()
    findings, rows = kernel_audit.card_k3(optin)
    assert not findings, [f.render() for f in findings]
    assert len(rows) == len(kernel_audit.design_points())


@pytest.mark.gpu
def test_a_launch_records_its_function_and_block_shape():
    """What the wrappers record as they launch, which phase 17's K3
    checks: the bf16 and the float32 route of flash attention each add
    their own function and block shape."""
    _cuda()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 64, 2, 64, generator=g).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        before = flash_ops.flash_attention.launched.copy()
        q = x.to(dtype)
        flash_ops.flash_attention(q, q, q)
        torch.cuda.synchronize()
        got = flash_ops.flash_attention.launched - before
        (point,) = got
        assert got[point] == 1
        if dtype == torch.bfloat16:
            assert point == flash_ops.tc_points(64)[0]
        else:
            assert point[0] == "flash_kernel<64>"


@pytest.mark.gpu
def test_run_check_holds_on_batched_probe():
    from repro_torch.analysis import sanitize
    _cuda()
    res = sanitize.check(sanitize.cases()["batched_probe"])
    assert not sanitize.findings_of(res), res


@pytest.mark.gpu
def test_run_check_sees_a_write_past_a_buffer_and_an_unwritten_one():
    """The guard itself: a launch that writes one element past its output
    breaks a canary margin, and one that returns its output unwritten
    differs between the two poisons."""
    from repro_torch.analysis import sanitize
    _cuda()

    def past_the_end(args, kw):
        out = torch.zeros_like(args[0])
        torch.as_strided(out, (out.numel() + 1,), (1,),
                         out.storage_offset()).fill_(7)
        return [out]

    def unwritten(args, kw):
        return [torch.empty_like(args[0])]

    make = lambda: ((torch.arange(64, dtype=torch.int32),), {})  # noqa
    counter = lambda: probe_ops.batched_probe   # noqa: E731
    for launch, field in ((past_the_end, "margins_intact"),
                          (unwritten, "poisons_agree")):
        res = sanitize.check(sanitize.Case("mutant", make, launch,
                                           lambda a, kw, got: None, counter))
        assert not getattr(res, field), res
        assert sanitize.findings_of(res)
