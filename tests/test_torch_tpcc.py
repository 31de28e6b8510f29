"""The port's TPC-C new-order slice against ``repro.db.tpcc``.

Both packages start from the reference's loaded state, carried across with
``repro_torch.convert``, and run the same new-order inputs: the port's
``draw`` replays the reference driver's ``split`` + ``gen_neworder`` stream.
Per round the outcomes, order ids, op counts and visibility counts must be
equal, and after the run every state leaf and the run statistics. All of
it is integers and bools: the tolerance is exact equality.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.tsoracle import VectorOracle as JOracle
from repro.db import tpcc as jtpcc, workload as jworkload

from repro_torch import convert
from repro_torch._u32 import np_to_i32
from repro_torch.core.tsoracle import VectorOracle
from repro_torch.db import tpcc, workload

SMALL = dict(n_warehouses=2, customers_per_district=8, n_items=64,
             n_threads=8, orders_per_thread=16, dist_degree=50.0)
FLAGS = dict(key_addressed=True, fused_commit=True, batched_probe=True)
CASES = {
    "slot_addressed": dict(SMALL),
    "key_addressed_kernels": dict(SMALL, **FLAGS),
    "warehouse_major": dict(SMALL, n_items=32, n_threads=4,
                            orders_per_thread=8, layout="warehouse_major",
                            **FLAGS),
}
N_ROUNDS = 4


def _eq(ref, port, what):
    a = np_to_i32(np.asarray(ref))
    b = port.cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_state(jst, pst):
    ref = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jst))
    port = jax.tree.leaves(convert.tpcc_state_to_numpy(pst))
    assert len(ref) == len(port)
    for (path, a), b in zip(ref, port):
        assert a.dtype == b.dtype, (jax.tree_util.keystr(path), a.dtype)
        np.testing.assert_array_equal(a, b,
                                      err_msg=jax.tree_util.keystr(path))


def _configs(name):
    kw = CASES[name]
    return jtpcc.TPCCConfig(**kw), tpcc.TPCCConfig(**kw)


def _draws(cfg, seed, n_rounds):
    """The reference driver's fresh inputs per round, converted."""
    logits = jworkload.zipf_logits(cfg.n_items, cfg.skew_alpha)
    key = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        inp = jworkload.gen_neworder(sub, cfg.n_threads, cfg.n_warehouses,
                                     cfg.n_items, cfg.customers_per_district,
                                     None, cfg.dist_degree, logits)
        draws.append(workload.NewOrderInputs(
            *(torch.from_numpy(np.array(x)) for x in inp)))
    return draws


def _recording(mod, rounds):
    fn = mod.neworder_round

    def rec(*a, **k):
        out = fn(*a, **k)
        rounds.append(out)
        return out
    return rec


@pytest.mark.parametrize("name", sorted(CASES))
def test_neworder_rounds_match_reference(name, monkeypatch):
    jcfg, cfg = _configs(name)
    lay, jst = jtpcc.init_tpcc(jcfg, JOracle(jcfg.n_threads),
                               jax.random.PRNGKey(0))
    pst = convert.tpcc_state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    _eq_state(jst, pst)                       # the carry is lossless

    jrounds, prounds = [], []
    monkeypatch.setattr(jtpcc, "neworder_round", _recording(jtpcc, jrounds))
    monkeypatch.setattr(tpcc, "neworder_round", _recording(tpcc, prounds))
    jst, jstats = jtpcc.run_neworder_rounds(
        jcfg, lay, jst, JOracle(jcfg.n_threads), jax.random.PRNGKey(1),
        N_ROUNDS)
    draws = _draws(jcfg, 1, N_ROUNDS)
    pst, pstats = tpcc.run_neworder_rounds(
        cfg, tpcc.make_layout(cfg), pst, VectorOracle(cfg.n_threads),
        lambda r: draws[r], N_ROUNDS, device="cpu")

    assert len(jrounds) == len(prounds) == N_ROUNDS
    for r, (jo, po) in enumerate(zip(jrounds, prounds)):
        for f in ("committed", "snapshot_miss", "o_id"):
            _eq(getattr(jo, f), getattr(po, f), f"round {r} {f}")
        for f in ("ops", "vis"):
            for g, a, b in zip(getattr(po, f)._fields, getattr(jo, f),
                               getattr(po, f)):
                _eq(a, b, f"round {r} {f}.{g}")
        _eq(jo.batch.read_slots, po.batch.read_slots, f"round {r} slots")
    _eq_state(jst, pst)
    _eq(jstats.committed, pstats.committed, "stats.committed")
    _eq(jstats.missed, pstats.missed, "stats.missed")
    for f in ("attempts", "commits", "retries", "abort_rate",
              "snapshot_misses", "contention_aborts", "ovf_reads",
              "ovf_peak", "gc_sweeps", "reclaim_traj"):
        assert getattr(jstats, f) == getattr(pstats, f), f
    assert tuple(jstats.ops) == tuple(pstats.ops)
    assert pstats.commits > 0 and pstats.retries > 0


@pytest.mark.parametrize("name,gc_interval", [("slot_addressed", 1),
                                              ("key_addressed_kernels", 2)])
def test_neworder_rounds_with_gc_match_reference(name, gc_interval):
    """Sustained new-order with the §5.3 GC thread on (sweeps, a reclaimed-
    slot-only mover, a log of 3 snapshots): outcomes, every statistic
    (``gc_sweeps`` and ``reclaim_traj`` included) and the state."""
    jcfg, cfg = _configs(name)
    lay, jst = jtpcc.init_tpcc(jcfg, JOracle(jcfg.n_threads),
                               jax.random.PRNGKey(0))
    pst = convert.tpcc_state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    n = 6
    gc = dict(gc_interval=gc_interval, max_txn_time=1, gc_snapshots=3)
    jst, js = jtpcc.run_neworder_rounds(
        jcfg, lay, jst, JOracle(jcfg.n_threads), jax.random.PRNGKey(4), n,
        **gc)
    draws = _draws(jcfg, 4, n)
    pst, ps = tpcc.run_neworder_rounds(
        cfg, lay, pst, VectorOracle(cfg.n_threads), lambda r: draws[r], n,
        device="cpu", **gc)
    _eq(js.committed, ps.committed, "committed")
    _eq(js.missed, ps.missed, "missed")
    for f in ps._fields:
        if f not in ("committed", "missed", "local_fraction"):
            assert getattr(js, f) == getattr(ps, f), f
    assert ps.gc_sweeps == n // gc_interval == len(ps.reclaim_traj)
    assert all(0 < frac < 1 for _, frac in ps.reclaim_traj)
    _eq_state(jst, pst)


@pytest.mark.parametrize("layout", ["table_major", "warehouse_major"])
def test_directory_and_loader_match_reference(layout):
    """``build_tpcc_directory`` equals the reference's; ``init_tpcc``'s
    generator-drawn columns fall in the reference's ranges and every other
    word of the loaded state equals the reference's."""
    kw = dict(SMALL, layout=layout, key_addressed=True)
    if layout == "warehouse_major":
        kw.update(n_threads=4, n_items=32)
    jcfg, cfg = jtpcc.TPCCConfig(**kw), tpcc.TPCCConfig(**kw)
    jlay = jtpcc.make_layout(jcfg)
    lay = tpcc.make_layout(cfg)
    assert lay.catalog.total_records == jlay.catalog.total_records
    assert tpcc.directory_buckets(cfg, lay) \
        == jtpcc.directory_buckets(jcfg, jlay)
    jd = jtpcc.build_tpcc_directory(jcfg, jlay)
    pd = tpcc.build_tpcc_directory(cfg, lay, device="cpu")
    _eq(jd.keys, pd.keys, "directory keys")
    _eq(jd.vals, pd.vals, "directory vals")

    _, jst = jtpcc.init_tpcc(jcfg, JOracle(jcfg.n_threads),
                             jax.random.PRNGKey(0))
    _, pst = tpcc.init_tpcc(cfg, VectorOracle(cfg.n_threads),
                            torch.Generator().manual_seed(3), device="cpu")
    W, I, D = cfg.n_warehouses, cfg.n_items, tpcc.DISTRICTS
    ar = lambda n: torch.arange(n, dtype=torch.int32)
    random_cols = [
        (tpcc.w_slot(lay, ar(W)), tpcc.W_COL["tax"], 0, 2000),
        (tpcc.d_slot(lay, ar(W).repeat_interleave(D), ar(D).repeat(W)),
         tpcc.D_COL["tax"], 0, 2000),
        (tpcc.i_slot(lay, ar(I)[None, :], ar(W)[:, None]).reshape(-1)
         if layout == "warehouse_major" else tpcc.i_slot(lay, ar(I)),
         tpcc.I_COL["price"], 100, 10000),
        (tpcc.s_slot(lay, cfg, ar(W).repeat_interleave(I), ar(I).repeat(W)),
         tpcc.S_COL["quantity"], 10, 101)]
    jdata = np.asarray(jst.nam.table.cur_data).copy()
    pdata = pst.nam.table.cur_data.clone()
    for slots, col, lo, hi in random_cols:
        vals = pdata[slots.long(), col]
        assert ((vals >= lo) & (vals < hi)).all(), col
        assert len(torch.unique(vals)) > 1
        jdata[slots.numpy(), col] = 0
        pdata[slots.long(), col] = 0
    _eq(jdata, pdata, "non-random payload words")
    # with the payloads equal by construction, every other leaf must be too
    pst = pst._replace(nam=pst.nam._replace(table=pst.nam.table._replace(
        cur_data=torch.from_numpy(np.array(jst.nam.table.cur_data)))))
    _eq_state(jst, pst)


def test_port_stream_draws_reference_ranges():
    """The port's own ``torch.Generator`` stream draws what the reference's
    distribution allows: distinct items per order, remote lines only on
    remote warehouses."""
    cfg = tpcc.TPCCConfig(**dict(SMALL, dist_degree=100.0))
    draw = workload.neworder_stream(cfg, torch.Generator().manual_seed(0))
    for r in range(3):
        inp = draw(r)
        T = cfg.n_threads
        assert inp.item_ids.shape == (T, tpcc.MAX_OL)
        for row in inp.item_ids:
            assert len(set(row.tolist())) == tpcc.MAX_OL
        assert ((inp.ol_cnt >= 5) & (inp.ol_cnt <= 15)).all()
        assert ((inp.qty >= 1) & (inp.qty <= 10)).all()
        assert ((inp.c_id >= 0) & (inp.c_id < cfg.customers_per_district)
                ).all()
        assert ((inp.w_id >= 0) & (inp.w_id < cfg.n_warehouses)).all()
        assert inp.is_remote[:, 0].all()          # every order distributed
        assert (inp.supply_w[inp.is_remote]
                != inp.w_id[:, None].expand_as(inp.supply_w)[inp.is_remote]
                ).all()
