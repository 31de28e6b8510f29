"""The port's durability path (§5.3 GC, §6.2 WAL, checkpoints, recovery)
against ``repro.db.tpcc`` and ``repro.checkpoint.snapshot``.

Both packages start from the reference's loaded state at the scale of the
reference's property P8 (4 warehouses, 8 threads, 4 rounds,
``tests/test_properties.py``) and run the same draws, converted through
numpy (the new-order driver's GC is held in ``test_torch_tpcc.py``). The
reference's uninterrupted run is made once per module. Held exactly: every
state leaf, every journal leaf, every run statistic (``gc_sweeps`` and
``reclaim_traj`` included) and every ``RecoveryReport`` field but its
seconds. A killed and recovered port run must also equal the port's
uninterrupted run. The checkpoint cases are those of
``tests/test_checkpoint.py`` plus one that changes a tensor in place after
``save_async`` returns.
"""
import json
import math
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import snapshot as jsnapshot
from repro.core.tsoracle import VectorOracle as JOracle
from repro.db import tpcc as jtpcc, workload as jworkload

from repro_torch import convert
from repro_torch.checkpoint import snapshot
from repro_torch.core import wal
from repro_torch.core.tsoracle import VectorOracle
from repro_torch.db import tpcc

from test_torch_mix import _conv
from test_torch_tpcc import _eq_state

P8 = dict(n_warehouses=4, customers_per_district=8, n_items=64, n_threads=8,
          orders_per_thread=16, dist_degree=30.0)
N_ROUNDS = 4
GC = dict(gc_interval=2, max_txn_time=1)
SEED = 3
KILLS = [(0, True), (0, False), (1, True), (1, False)]


def _mixed_draws(jcfg, seed, n_rounds):
    """The reference driver's per-round ``gen_mixed`` draws, converted."""
    logits = jworkload.zipf_logits(jcfg.n_items, jcfg.skew_alpha)
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        draws.append(_conv(jworkload.gen_mixed(
            sub, jcfg.n_threads, jcfg.n_warehouses, jcfg.n_items,
            jcfg.customers_per_district, None, jcfg.dist_degree, logits)))
    return draws


def _journal_of(log):
    """The journal the last write sub-round of a reference run returned
    (its driver keeps the journal to itself)."""
    return [o.journal for _, o in log][-1]


def _record(monkeypatch, log):
    for name in ("neworder_round", "payment_round", "delivery_round"):
        fn = getattr(jtpcc, name)

        def rec(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            log.append((_name, out))
            return out
        monkeypatch.setattr(jtpcc, name, rec)


@pytest.fixture(scope="module")
def start():
    jcfg, cfg = jtpcc.TPCCConfig(**P8), tpcc.TPCCConfig(**P8)
    oracle = JOracle(jcfg.n_threads)
    lay, jst = jtpcc.init_tpcc(jcfg, oracle, jax.random.PRNGKey(1))
    return jcfg, cfg, lay, jax.tree.map(np.asarray, jst), \
        _mixed_draws(jcfg, SEED, N_ROUNDS)


def _ref_run(start, failure):
    jcfg, _, lay, jst, _ = start
    oracle = JOracle(jcfg.n_threads)
    jnl = jtpcc.make_journal(jcfg, oracle, capacity_rounds=N_ROUNDS + 2)
    log = []
    with pytest.MonkeyPatch.context() as mp, \
            tempfile.TemporaryDirectory() as d:
        _record(mp, log)
        st, ms = jtpcc.run_mixed_rounds(
            jcfg, lay, jax.tree.map(jax.numpy.asarray, jst), oracle,
            jax.random.PRNGKey(SEED), N_ROUNDS, journal=jnl,
            checkpoint_dir=d, failure=failure, **GC)
    return st, ms, _journal_of(log)


def _port_run(start, failure, draw=None):
    _, cfg, lay, jst, draws = start
    oracle = VectorOracle(cfg.n_threads)
    jnl = tpcc.make_journal(cfg, oracle, capacity_rounds=N_ROUNDS + 2,
                            device="cpu")
    with tempfile.TemporaryDirectory() as d:
        st, ms = tpcc.run_mixed_rounds(
            cfg, lay, convert.tpcc_state_from_numpy(jst, "cpu"), oracle,
            draw or (lambda r: draws[r]), N_ROUNDS, journal=jnl,
            checkpoint_dir=d, failure=failure, device="cpu", **GC)
    return st, ms, jnl


@pytest.fixture(scope="module")
def uninterrupted(start):
    return _ref_run(start, None), _port_run(start, None)


def _same(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


def _eq_stats(js, ps, skip=()):
    for f in ps._fields:
        if f == "recovery" or f in skip:
            continue
        assert _same(getattr(js, f), getattr(ps, f)), f
    assert not set(js._fields) - set(ps._fields) - {"growth"}, \
        "a statistic of the reference is missing"


def _eq_journal(jj, pj, what="journal"):
    for f, a, b in zip(pj._fields, jj, convert.journal_to_numpy(pj)):
        assert a.dtype == b.dtype, (what, f)
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{what}.{f}")


def _resolved_entries(j: wal.Journal):
    """Replica 0's entries in append order with the undetermined ones
    dropped (the rings here never wrap), and the count of those."""
    pos = torch.arange(j.capacity)[None, :]
    keep = j.resolved[0] & (pos < j.used[:, None])
    return [getattr(j, f)[0][keep] for f in wal.ENTRY_FIELDS], \
        int((~j.resolved[0] & (pos < j.used[:, None])).sum())


# ------------------------------------------------ journal + checkpoints --
def test_journalled_mix_matches_reference(uninterrupted):
    """A journalled, checkpointed mix with GC on: state, every journal
    leaf and every statistic equal the reference's."""
    (jst, js, jj), (pst, ps, pj) = uninterrupted
    _eq_state(jst, pst)
    _eq_journal(jj, pj)
    _eq_stats(js, ps)
    assert ps.gc_sweeps == N_ROUNDS // GC["gc_interval"]
    assert ps.recovery == ()
    assert (pj.resolved[0] == pj.resolved[1]).all()
    assert pj.committed[0].any() and int(pj.used.min()) > 0


def test_journals_of_both_commit_renderings_are_identical(start):
    """The intents are logged before either commit rendering, so the
    kernel flags change no byte of the journal (the plain versions stand
    for the kernels on the CPU)."""
    _, cfg, lay, jst, draws = start
    flags = dict(key_addressed=True, batched_probe=True)
    out = []
    for fused in (False, True):
        c = tpcc.TPCCConfig(**{**cfg.__dict__, **flags,
                               "fused_commit": fused})
        lay_k, st = tpcc.init_tpcc(c, VectorOracle(c.n_threads),
                                   device="cpu")
        jnl = tpcc.make_journal(c, VectorOracle(c.n_threads),
                                capacity_rounds=N_ROUNDS + 2, device="cpu")
        tpcc.run_mixed_rounds(c, lay_k, st, VectorOracle(c.n_threads),
                              lambda r: draws[r], N_ROUNDS, journal=jnl,
                              device="cpu", **GC)
        out.append(jnl)
    for f, a, b in zip(wal.Journal._fields, *out):
        assert torch.equal(a, b), f


# ------------------------------------------------------ kill + recovery --
@pytest.mark.parametrize("kill_round,in_flight", KILLS)
def test_kill_and_recover_matches_reference_and_uninterrupted(
        start, uninterrupted, kill_round, in_flight):
    failure = tpcc.FailureInjector(kill_round=kill_round,
                                   in_flight=in_flight)
    jst, js, jj = _ref_run(start, jtpcc.FailureInjector(
        kill_round=kill_round, in_flight=in_flight))
    pst, ps, pj = _port_run(start, failure)
    # the reference's recovered run, leaf for leaf
    _eq_state(jst, pst)
    _eq_journal(jj, pj)
    _eq_stats(js, ps)
    (jrep,), (prep,) = js.recovery, ps.recovery
    for f in prep._fields:
        if f != "recovery_seconds":
            assert getattr(jrep, f) == getattr(prep, f), f
    assert prep.checkpoint_round < kill_round
    assert (prep.undetermined > 0) == in_flight
    # the port's uninterrupted run
    _, (ust, us, uj) = uninterrupted
    for a, b in zip(convert.tpcc_state_to_numpy(ust),
                    convert.tpcc_state_to_numpy(pst)):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)
    _eq_stats(us, ps)
    (ue, u_undet), (pe, n_undet) = _resolved_entries(uj), \
        _resolved_entries(pj)
    assert u_undet == 0 and n_undet == prep.undetermined
    for f, a, b in zip(wal.ENTRY_FIELDS, ue, pe):
        assert torch.equal(a, b), f
    assert int((pj.used - uj.used).sum()) == n_undet
    if not in_flight:
        for f, a, b in zip(wal.Journal._fields, uj, pj):
            assert torch.equal(a, b), f


def test_in_flight_kill_needs_a_pure_draw(start):
    """The driver draws the kill round twice; a draw that is not a pure
    function of the round is refused, not silently replayed."""
    _, _, _, _, draws = start
    calls = []

    def impure(r):
        calls.append(r)
        d = draws[r]
        if calls.count(r) == 2:   # the second call gives other inputs
            d = d._replace(txn_type=(d.txn_type + 1) % 5)
        return d
    with pytest.raises(ValueError, match="pure function of the round"):
        _port_run(start, tpcc.FailureInjector(kill_round=1), draw=impure)
    assert calls.count(1) == 2


def test_failure_needs_a_journal_and_a_checkpoint(start):
    _, cfg, lay, jst, draws = start
    st = convert.tpcc_state_from_numpy(jst, "cpu")
    with pytest.raises(ValueError, match="journal and a checkpoint_dir"):
        tpcc.run_mixed_rounds(cfg, lay, st, VectorOracle(cfg.n_threads),
                              lambda r: draws[r], 1, device="cpu",
                              failure=tpcc.FailureInjector(kill_round=0))
    # over memory servers, the dead server must be one of them
    oracle = VectorOracle(cfg.n_threads)
    engine = tpcc.make_mixed_engine(cfg, lay, 2, oracle)
    jnl = tpcc.make_journal(cfg, oracle, capacity_rounds=1, device="cpu")
    with pytest.raises(ValueError, match="outside the 2-server mesh"):
        tpcc.recover_from_failure(
            cfg, lay, st, engine, jnl, "",
            tpcc.FailureInjector(kill_round=0, dead_server=2), use_gc=False)


# ------------------------------------------------------------ checkpoints --
def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(8, 16).astype(np.float32),
            "b": rng.randn(16).astype(np.float32),
            "nested": {"u0": np.arange(12, dtype=np.int32),
                       "bits": np.array([0xFFFFFFFF, 3], np.uint32)}}


def _port_tree(t):
    return {"w": torch.from_numpy(t["w"]).to(torch.bfloat16),
            "b": torch.from_numpy(t["b"]),
            "nested": {"u0": torch.from_numpy(t["nested"]["u0"]),
                       "bits": torch.from_numpy(
                           t["nested"]["bits"].view(np.int32))},
            "none": None}


def test_checkpoint_roundtrip_and_format_match_reference(tmp_path):
    """Round trip of a tree with bfloat16, int32 and uint32-word leaves
    and commit vector; the files and the manifest's leaf entries are the
    reference's for the same tree, and each side restores the other's."""
    t = _tree(0)
    pt = _port_tree(t)
    snapshot.save(str(tmp_path / "p"), pt, {"step": torch.tensor(5)},
                  step=42, commit_vector=torch.tensor([3, 1, 4]))
    p2, o2, meta = snapshot.restore(str(tmp_path / "p"), pt,
                                    {"step": torch.tensor(0)})
    assert meta["step"] == 42 and meta["commit_vector"] == [3, 1, 4]
    assert int(o2["step"]) == 5 and p2["none"] is None
    for a, b in zip(snapshot._items(pt), snapshot._items(p2)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1]), a[0]
    jt = jax.tree.map(jax.numpy.asarray, {**t, "w": t["w"].astype(
        jax.numpy.bfloat16)})
    jsnapshot.save(str(tmp_path / "j"), jt, step=42)
    jman = json.load(open(tmp_path / "j" / "manifest.json"))
    pman = json.load(open(tmp_path / "p" / "manifest.json"))
    jleaves = jman["leaves"]
    pleaves = {k: v for k, v in pman["leaves"].items()
               if k.startswith("params/")}
    assert list(jleaves) == list(pleaves)
    for k, v in jleaves.items():
        assert v["file"] == pleaves[k]["file"]
        assert v["shape"] == pleaves[k]["shape"]
    # each side restores the other's checkpoint into its own structure
    pj, _, _ = snapshot.restore(str(tmp_path / "j"), {
        k: v for k, v in pt.items() if k != "none"})
    assert torch.equal(pj["w"], pt["w"])
    assert torch.equal(pj["nested"]["bits"], pt["nested"]["bits"])
    jp, _, _ = jsnapshot.restore(str(tmp_path / "p"), jt)
    np.testing.assert_array_equal(np.asarray(jp["nested"]["bits"]),
                                  t["nested"]["bits"])
    with pytest.raises(NotImplementedError, match="one card"):
        snapshot.restore(str(tmp_path / "p"), pt, shardings={"params": {}})
    with pytest.raises(ValueError, match="different deployment"):
        snapshot.restore(str(tmp_path / "p"), {**pt, "b": torch.zeros(3)})


def test_checkpoint_manifest_commit_is_atomic(tmp_path):
    snapshot.save(str(tmp_path), _port_tree(_tree(1)), step=1)
    assert os.path.exists(tmp_path / "manifest.json")
    assert not os.path.exists(tmp_path / "manifest.json.tmp")
    man = json.load(open(tmp_path / "manifest.json"))
    for leaf in man["leaves"].values():
        assert os.path.exists(tmp_path / leaf["file"])


def test_save_async_joins_and_matches(tmp_path):
    pt = _port_tree(_tree(2))
    t = snapshot.save_async(str(tmp_path), pt, step=7)
    t.join(timeout=60)
    assert not t.is_alive()
    p2, _, meta = snapshot.restore(str(tmp_path), pt)
    assert meta["step"] == 7 and torch.equal(p2["w"], pt["w"])


def test_save_async_is_not_torn_by_an_in_place_update(tmp_path):
    """The pool changes in place: ``save_async`` must have copied every
    leaf before it returns, so a change right after it is not saved."""
    pt = _port_tree(_tree(3))
    before = pt["nested"]["u0"].clone()
    t = snapshot.save_async(str(tmp_path), pt, step=3)
    pt["nested"]["u0"].add_(100)
    pt["w"].zero_()
    t.join(timeout=60)
    assert not t.is_alive()
    p2, _, _ = snapshot.restore(str(tmp_path), pt)
    assert torch.equal(p2["nested"]["u0"], before)
    assert torch.equal(p2["w"], _port_tree(_tree(3))["w"])
