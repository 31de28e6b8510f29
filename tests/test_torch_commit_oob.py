"""The commit path on out-of-range indices, against the reference.

JAX reads a bad index one way and writes it another: a gather wraps a
negative index once and then clamps it into range, a scatter wraps once and
then drops what is still out of range. The port's commit path
(``cas.arbitrate``, ``cas.release``, ``mvcc.install``,
``si.commit_write_sets``, ``fused_commit_ref``) and its vector oracle's
``make_visible`` must do the same, leaf for leaf and bit for bit. One
consequence is pinned on its own: a request whose slot is out of range
reads the winner of the record its gathers clamp to, so when it shares
that winner's priority it is granted, its transaction can commit, and it
writes nothing. So is the rule for two committing requests on one record
(the highest lane's version becomes current), which is what the
reference's in-order scatter gives on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cas as jcas, mvcc as jmvcc, si as jsi
from repro.core.tsoracle import VectorOracle as JOracle
from repro.kernels.commit import ops as jcommit_ops
from repro.kernels.commit import ref as jcommit_ref

from repro_torch._u32 import np_to_i32
from repro_torch.core import cas, mvcc, si
from repro_torch.core.tsoracle import VectorOracle
from repro_torch.kernels.commit import ref as commit_ref

from test_torch_gpu import (COMMIT_OUT, OOB_SLOTS, commit_dup_case,
                            commit_many_case, commit_oob_case, flat_commit,
                            gather_slot, port_commit, port_table, _t)

CASES = [(n, sp) for sp in (False, True) for n in OOB_SLOTS]
IDS = [f"{n}{'-same_prio' if sp else ''}" for n, sp in CASES]


def _eq(ref, port, what):
    a = np_to_i32(np.asarray(ref))
    b = port.numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _jtable(tbl):
    return jmvcc.VersionedTable(**{k: jnp.asarray(v) for k, v in tbl.items()})


def _requests(args):
    """``(slots, expected, prio, active, txn, new_hdr, new_data)``."""
    return args[1:8]


@pytest.mark.parametrize("name,same_prio", CASES, ids=IDS)
def test_cas_arbitrate_and_release_out_of_range_match_reference(
        name, same_prio):
    tbl, args = commit_oob_case(name, same_prio)
    slots, expected, prio, active = _requests(args)[:4]
    jres = jcas.arbitrate(jnp.asarray(tbl["cur_hdr"]), jnp.asarray(slots),
                          jnp.asarray(expected), jnp.asarray(prio),
                          jnp.asarray(active))
    tres = cas.arbitrate(_t(tbl["cur_hdr"]), _t(slots), _t(expected),
                         _t(prio), torch.from_numpy(active))
    _eq(jres.granted, tres.granted, "granted")
    _eq(jres.new_hdr, tres.new_hdr, "new_hdr")
    mask = np.asarray(jres.granted).copy()   # every grant, lane 2's included
    _eq(jcas.release(jres.new_hdr, jnp.asarray(slots), jnp.asarray(mask)),
        cas.release(tres.new_hdr, _t(slots), torch.from_numpy(mask)),
        "release")
    # lane 2 wins alone in range (R-1, -1; -R's record 0 is locked), and
    # beside lane 1's bid of its priority anywhere
    assert bool(mask[2]) == (same_prio or name in ("R-1", "-1"))


@pytest.mark.parametrize("name,same_prio", CASES, ids=IDS)
def test_mvcc_install_out_of_range_matches_reference(name, same_prio):
    """Every active request installs: the gathers clamp lane 2's slot, the
    five scatters drop it, and with ``same_prio`` lanes 1 and 2 name one
    record when lane 2's slot wraps into range."""
    tbl, args = commit_oob_case(name, same_prio)
    slots, _, _, active, _, new_hdr, new_data = _requests(args)
    jout = jmvcc.install(_jtable(tbl), jnp.asarray(slots),
                         jnp.asarray(new_hdr), jnp.asarray(new_data),
                         jnp.asarray(active))
    tout = mvcc.install(port_table(tbl), _t(slots), _t(new_hdr),
                        _t(new_data), torch.from_numpy(active))
    _eq(jout.installed, tout.installed, "installed")
    for f in tout.table._fields:
        _eq(getattr(jout.table, f), getattr(tout.table, f), f)


def _commit_write_sets(pkg_si, table, args, conv):
    slots, expected, prio, active, txn, new_hdr, new_data = (
        conv(a) for a in _requests(args))
    return pkg_si.commit_write_sets(table, slots, expected, prio, active,
                                    txn, new_hdr, new_data, conv(args[8]),
                                    ext_fails=conv(args[11]))


def _np_bool(a):
    return torch.from_numpy(a) if a.dtype == bool else _t(a)


@pytest.mark.parametrize("name,same_prio", CASES, ids=IDS)
def test_commit_write_sets_out_of_range_matches_reference(name, same_prio):
    tbl, args = commit_oob_case(name, same_prio)
    ref = _commit_write_sets(jsi, _jtable(tbl), args, jnp.asarray)
    port = _commit_write_sets(si, port_table(tbl), args, _np_bool)
    for f in port._fields:
        if f == "table":
            for g in port.table._fields:
                _eq(getattr(ref.table, g), getattr(port.table, g), g)
        else:
            _eq(getattr(ref, f), getattr(port, f), f)


@pytest.mark.parametrize("name,same_prio", CASES, ids=IDS)
def test_fused_commit_ref_out_of_range_matches_reference(name, same_prio):
    case = commit_oob_case(name, same_prio)
    tbl, args = case
    ref = jcommit_ref.fused_commit_ref(_jtable(tbl),
                                       *(jnp.asarray(a) for a in args))
    port = port_commit(commit_ref.fused_commit_ref, case)
    for n, a, b in zip(COMMIT_OUT, flat_commit(ref), port):
        _eq(a, b, n)


def test_pallas_commit_reads_an_out_of_range_victim_flat():
    """A fact about the reference, pinned: the Pallas kernel gathers the
    ring victim of slot R as ``old[slot * K + wpos]`` from the flattened
    rings, which clamps to the last entry of record R-1, where
    ``si.commit_write_sets`` reads ``old_hdr[R-1, wpos]``. With only the
    latter moved, the production body commits txn0 and the Pallas kernel
    aborts it. The port follows the production body."""
    case = commit_oob_case("R", same_prio=True)
    tbl, args = case
    w = int(tbl["next_write"][63]) % 2
    assert w == 0
    tbl["old_hdr"][63, 1, 0] &= ~np.uint32(4)
    ref = jcommit_ref.fused_commit_ref(_jtable(tbl),
                                       *(jnp.asarray(a) for a in args))
    ker = jcommit_ops.fused_commit(_jtable(tbl),
                                   *(jnp.asarray(a) for a in args),
                                   interpret=True)
    assert bool(ref.committed[0]) and not bool(ker.committed[0])
    port = port_commit(commit_ref.fused_commit_ref, case)
    for n, a, b in zip(COMMIT_OUT, flat_commit(ref), port):
        _eq(a, b, n)


@pytest.mark.parametrize("name", ["R", "R+5", "-R-1"])
def test_out_of_range_lane_of_winning_priority_commits_and_writes_nothing(
        name):
    """Lane 2's slot is out of range once negatives wrap; its gathers read
    the record lane 1 wins with the same priority. Lane 2 is granted and
    effective, txn0 commits, and only lane 1's install lands."""
    tbl, args = commit_oob_case(name, same_prio=True)
    R = tbl["cur_hdr"].shape[0]
    g = gather_slot(int(args[1][2]), R)
    ref = jcommit_ref.fused_commit_ref(_jtable(tbl),
                                       *(jnp.asarray(a) for a in args))
    port = port_commit(commit_ref.fused_commit_ref, (tbl, args))
    out = dict(zip(COMMIT_OUT, port))
    assert out["granted"][1] and out["granted"][2]
    assert out["committed"][0] and out["do_install"][2]
    assert out["table.next_write"][g] == tbl["next_write"][g] + 1
    np.testing.assert_array_equal(out["table.cur_data"][g].numpy(),
                                  args[7][1])
    for n, a, b in zip(COMMIT_OUT, flat_commit(ref), port):
        _eq(a, b, n)


def test_same_priority_out_of_range_lane_is_granted():
    """R = 8, slots [7, 8, 3], priorities [5, 5, 9]: lane 1's bid on slot 8
    is dropped, but its won test reads slot 7, where lane 0 bid the same
    priority, so every lane is granted. With lane 0 on slot 0, lane 1 is
    denied."""
    R = 8
    hdrs = np.zeros((R, 2), np.uint32)
    prio = np.array([5, 5, 9], np.uint32)
    active = np.ones(3, bool)
    for first, granted in ((7, [True, True, True]), (0, [True, False, True])):
        slots = np.array([first, 8, 3], np.int32)
        expected = hdrs[np.clip(slots, 0, R - 1)]
        jres = jcas.arbitrate(jnp.asarray(hdrs), jnp.asarray(slots),
                              jnp.asarray(expected), jnp.asarray(prio),
                              jnp.asarray(active))
        tres = cas.arbitrate(_t(hdrs), _t(slots), _t(expected), _t(prio),
                             torch.from_numpy(active))
        assert np.asarray(jres.granted).tolist() == granted
        _eq(jres.granted, tres.granted, "granted")
        _eq(jres.new_hdr, tres.new_hdr, "new_hdr")


@pytest.mark.parametrize("tid,vec", [([0, 1, 4], [5, 6, 0, 0]),
                                     ([0, 1, -1], [5, 6, 0, 7]),
                                     ([0, 1, -5], [5, 6, 0, 0])])
def test_make_visible_out_of_range_matches_reference(tid, vec):
    """A thread id wraps once if negative and is dropped if still out of
    range; the flags-off round's oracle and the fused commit's plain
    make-visible agree."""
    n = 4
    cts = np.array([5, 6, 7], np.uint32)
    tid = np.array(tid, np.int32)
    js = JOracle(n).make_visible(JOracle(n).init(), jnp.asarray(tid),
                                 jnp.asarray(cts))
    o = VectorOracle(n)
    ts = o.make_visible(o.init(device="cpu"), _t(tid), _t(cts))
    assert np.asarray(js.vec).tolist() == vec
    _eq(js.vec, ts.vec, "vec")
    fused = commit_ref.make_visible(torch.zeros(n, dtype=torch.int32),
                                    _t(tid), _t(cts),
                                    torch.ones(3, dtype=torch.bool))
    assert torch.equal(fused, ts.vec)


@pytest.mark.parametrize("across", [False, True], ids=["one_txn", "two_txns"])
def test_duplicate_slot_payloads_match_reference(across):
    """Two committing requests on record 19 with different payloads: both
    move the same current version and advance ``next_write`` by two, and
    the highest lane's header and payload become current."""
    case = commit_dup_case(across)
    tbl, args = case
    ref = jcommit_ref.fused_commit_ref(_jtable(tbl),
                                       *(jnp.asarray(a) for a in args))
    port = port_commit(commit_ref.fused_commit_ref, case)
    for n, a, b in zip(COMMIT_OUT, flat_commit(ref), port):
        _eq(a, b, n)
    out = dict(zip(COMMIT_OUT, port))
    lanes = [2, 18] if across else [18, 19]
    assert out["do_install"][lanes].all()
    assert out["table.next_write"][19] == tbl["next_write"][19] + 2
    np.testing.assert_array_equal(out["table.cur_data"][19].numpy(),
                                  args[7][lanes[1]])
    assert not np.array_equal(args[7][lanes[0]], args[7][lanes[1]])
    _eq(np.asarray(args[6][lanes[1]]) & ~np.uint32(1),
        out["table.cur_hdr"][19], "cur_hdr[19]")


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_commit_ref_many_requests_matches_reference(seed):
    """The card tests' 20,000-request case: hot and doubly written slots,
    shared priorities, slots and vector slots out of range."""
    case = commit_many_case(seed)
    tbl, args = case
    ref = jcommit_ref.fused_commit_ref(_jtable(tbl),
                                       *(jnp.asarray(a) for a in args))
    port = port_commit(commit_ref.fused_commit_ref, case)
    for n, a, b in zip(COMMIT_OUT, flat_commit(ref), port):
        _eq(a, b, n)
