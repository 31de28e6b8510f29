"""The port's timestamp oracles against ``repro.core.tsoracle``, and
``si.run_round``, ``si.run_rounds`` and both TPC-C drivers under each of
the four designs against the reference.

Every input is made from a seed with numpy (or is the reference's own
draw, converted), so both packages see the same words. The oracle
functions are held on their wrap cases: ``want`` all false (a rank of -1),
``cts`` below the bitmap's origin, a counter near 2^32, the bitmap's
capacity overrun, slots out of range. ``run_round`` runs with the commit
kernel's flag off and on (on the CPU the wrapper runs its in-place plain
twin); the naive adapter's make-visible overwrites its vector, so an
oracle whose make-visible publishes nothing shows that the kernel writes
a scratch copy for any oracle but the vector ones. The
drivers are held on one server under all four oracles, and the
compressed oracle over 4 memory servers against the reference's
one-server run. The naive adapter's stall past its capacity is pinned, and
its refusal over servers and in recovery stands beside the reference's own
failure there. Every comparison is exact.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import cas as jcas, header as jheader, mvcc as jmvcc, \
    si as jsi, tsoracle as jts
from repro.db import tpcc as jtpcc

from repro_torch import convert
from repro_torch._u32 import np_to_i32
from repro_torch.core import cas, header, mvcc, si, store, \
    tsoracle as ts
from repro_torch.db import tpcc, workload

from _si_common import gen_batch, make_compute
from test_torch_durability import _eq_journal, _eq_stats
from _torch_tpcc_common import _mixed_draws
from test_torch_mix import READ_TYPES, ROUND_FNS, TEST_MIX, WRITE_TYPES, \
    _eq_readonly, _eq_write, _recording
from test_torch_tpcc import _draws as _neworder_draws, _eq, _eq_state

U32 = np.uint32


def _pair(cls_j, cls_p, *arrays):
    """The same uint32 words as a reference state and a port state."""
    return cls_j(*map(jnp.asarray, arrays)), \
        cls_p(*(torch.from_numpy(np_to_i32(a)) for a in arrays))


def _eq_oracle(jstate, pstate, what):
    ref = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jstate))
    port = jax.tree.leaves(convert.oracle_state_to_numpy(pstate))
    assert len(ref) == len(port), what
    for (path, a), b in zip(ref, port):
        key = f"{what}{jax.tree_util.keystr(path)}"
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)


# -------------------------------------------- the global counter (§3.1) ----
# (counter, rts, offset, capacity, bitmap prefix set, the cts completed)
GC_CASES = {
    "fresh": (0, 0, 1, 64, 0, None),
    "holes": (40, 20, 1, 64, 20, np.array([22, 23, 25, 26, 60, 22], U32)),
    "counter_near_2_32": ((1 << 32) - 5, (1 << 32) - 9, (1 << 32) - 12, 64,
                          3, None),
    "cts_below_offset": (120, 99, 100, 64, 0,
                         np.array([50, 99, 100, 101, 3], U32)),
    "capacity_overrun": (300, 64, 1, 64, 64,
                         np.array([64, 65, 200, 301], U32)),
}


@pytest.mark.parametrize("name", sorted(GC_CASES))
def test_global_counter_matches_reference(name):
    cts0, rts0, off0, cap, done, complete = GC_CASES[name]
    rng = np.random.default_rng(len(name))
    bitmap = np.zeros((cap,), U32)
    bitmap[:done] = 1
    bitmap[done + 2:] = rng.random(max(0, cap - done - 2)) < 0.3   # a hole
    js, ps = _pair(jts.GlobalCounterState, ts.GlobalCounterState,
                   np.array([cts0], U32), np.array([rts0], U32), bitmap,
                   np.array([off0], U32))
    jo, po = jts.GlobalCounterOracle(cap), ts.GlobalCounterOracle(cap)
    js, jcts = jo.fetch_commit_ts(js, 8)
    ps, pcts = po.fetch_commit_ts(ps, 8)
    _eq(jcts, pcts, "fetched cts")
    _eq_oracle(js, ps, "fetch")
    if complete is None:
        jdone, pdone = jcts, pcts
    else:
        jdone, pdone = jnp.asarray(complete), torch.from_numpy(
            np_to_i32(complete))
    committed = rng.random(jdone.shape[0]) < 0.5
    js = jo.complete(js, jdone, jnp.asarray(committed))
    ps = po.complete(ps, pdone, torch.from_numpy(committed))
    _eq_oracle(js, ps, "complete")
    js, ps = jo.advance(js), po.advance(ps)
    _eq_oracle(js, ps, "advance")
    _eq(jo.read(js), po.read(ps), "read")


# ------------------------------------------------- vector oracles (§4) ----
# (n_threads, threads_per_server, tids, want all false)
COMPRESSED_CASES = {
    "x1": (16, 1, None, False),
    "x2": (16, 2, None, False),
    "x8": (16, 8, None, False),
    "x8_none_want": (16, 8, None, True),
    "slots_out_of_range": (10, 4, np.array([0, 3, 8, 9, 12, -1, -9, 5],
                                           np.int32), False),
}


@pytest.mark.parametrize("name", sorted(COMPRESSED_CASES))
def test_compressed_oracle_matches_reference(name):
    T, per, tids, none = COMPRESSED_CASES[name]
    rng = np.random.default_rng(7)
    jo = jts.CompressedVectorOracle(T, threads_per_server=per)
    po = ts.CompressedVectorOracle(T, threads_per_server=per)
    assert jo.n_slots == po.n_slots
    vec = rng.integers(0, 1 << 32, jo.n_slots, dtype=np.uint64).astype(U32)
    vec[0] = 0xFFFFFFFF                                 # + 1 wraps to 0
    js, ps = _pair(jts.VectorState, ts.VectorState, vec)
    tids = np.arange(T, dtype=np.int32) if tids is None else tids
    want = np.zeros(tids.shape, bool) if none else rng.random(tids.shape) < .6
    jt, pt = jnp.asarray(tids), torch.from_numpy(tids)
    jcts = jo.next_commit_ts_batch(js, jt, jnp.asarray(want))
    pcts = po.next_commit_ts_batch(ps, pt, torch.from_numpy(want))
    _eq(jcts, pcts, "next_commit_ts_batch")
    inside = (tids >= 0) & (tids < T)
    _eq(jo.next_commit_ts(js, jt[inside]), po.next_commit_ts(ps, pt[inside]),
        "next_commit_ts")
    js = jo.make_visible(js, jt, jcts, jnp.asarray(want))
    ps = po.make_visible(ps, pt, pcts, torch.from_numpy(want))
    _eq_oracle(js, ps, "make_visible")
    _eq(jo.slot_of_thread(jt), po.slot_of_thread(pt), "slot_of_thread")


@pytest.mark.parametrize("near_wrap", [False, True])
def test_naive_adapter_matches_reference(near_wrap):
    """Four rounds of 16 threads against a capacity of 32: the counter
    passes the capacity in the third, and near 2^32 it wraps."""
    rng = np.random.default_rng(3)
    T, cap = 16, 32
    jo, po = jts.NaiveOracleAdapter(T, cap), ts.NaiveOracleAdapter(T, cap)
    js, ps = jo.init(), po.init(device="cpu")
    _eq_oracle(js, ps, "init")
    if near_wrap:
        start = np.array([(1 << 32) - 20], U32)
        js = js._replace(gc=js.gc._replace(cts=jnp.asarray(start)))
        ps.gc.cts.copy_(torch.from_numpy(np_to_i32(start)))
    tids = np.arange(T, dtype=np.int32)
    for r in range(4):
        want = rng.random(T) < 0.5
        jcts = jo.next_commit_ts_batch(js, jnp.asarray(tids),
                                       jnp.asarray(want))
        pcts = po.next_commit_ts_batch(ps, torch.from_numpy(tids),
                                       torch.from_numpy(want))
        _eq(jcts, pcts, f"round {r} cts")
        js = jo.make_visible(js, jnp.asarray(tids), jcts, jnp.asarray(want))
        ps = po.make_visible(ps, torch.from_numpy(tids), pcts,
                             torch.from_numpy(want))
        _eq_oracle(js, ps, f"round {r}")
        _eq(jo.read(js), po.read(ps), f"round {r} read")
    _eq(jo.slot_of_thread(jnp.asarray(tids)),
        po.slot_of_thread(torch.from_numpy(tids)), "slot_of_thread")


def test_staleness_window_and_snapshot_summary_match_reference():
    rng = np.random.default_rng(5)
    hist = rng.integers(0, 1 << 32, (3, 4), dtype=np.uint64).astype(U32)
    for k in (0, 1, 2, 9):
        _eq(jts.staleness_window(jnp.asarray(hist), k),
            ts.staleness_window(torch.from_numpy(np_to_i32(hist)), k),
            f"staleness_window k={k}")
    for vec in (np.full((8,), 0xFFFFFFFF, U32), hist[0], np.zeros(1, U32)):
        ref = jts.snapshot_summary(jnp.asarray(vec))
        port = ts.snapshot_summary(torch.from_numpy(np_to_i32(vec)))
        assert type(ref) is type(port) and ref == port, (ref, port)
    assert ts.snapshot_summary(torch.full((8,), -1, dtype=torch.int32)) \
        == 8 * 0xFFFFFFFF


# ------------------------------------------------------ si.run_round ----
N_REC, W, T_SI, RS, WS, ROUNDS = 32, 4, 8, 2, 1, 6
SI_ORACLES = {
    "vector": lambda m: m.VectorOracle(T_SI),
    "naive": lambda m: m.NaiveOracleAdapter(T_SI),
    "naive_cap16": lambda m: m.NaiveOracleAdapter(T_SI, capacity=16),
    "compressed_x4": lambda m: m.CompressedVectorOracle(T_SI, 4),
    "compressed_x8": lambda m: m.CompressedVectorOracle(T_SI, 8),
    "partitioned": lambda m: m.PartitionedVectorOracle(T_SI, n_parts=4),
}


def _port_batch(jbatch):
    return si.TxnBatch(*(torch.from_numpy(np.array(x)) for x in jbatch))


def _port_compute(batch):
    """``_si_common.make_compute``'s rule in torch."""
    def fn(rh, rd, vec):
        wref = batch.write_ref.clamp(0, rd.shape[1] - 1).long()
        base = rd.gather(1, wref[:, :, None].expand(-1, -1, rd.shape[2]))
        return base + (batch.tid + 1)[:, None, None]
    return fn


def _port_table(jtable):
    return mvcc.VersionedTable(*(torch.from_numpy(np_to_i32(np.array(x)))
                                 for x in jtable))


def _eq_table(jtable, ptable, what):
    for f, a, b in zip(ptable._fields, jtable, ptable):
        _eq(a, b, f"{what} {f}")


@pytest.fixture(scope="module")
def si_batches():
    rng = np.random.default_rng(0)
    return [gen_batch(rng, N_REC, T_SI, RS, WS) for _ in range(ROUNDS)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", sorted(SI_ORACLES))
def test_run_round_matches_reference(name, fused, si_batches):
    jo, po = SI_ORACLES[name](jts), SI_ORACLES[name](ts)
    js = jo.init()
    jtab = jmvcc.init_table(N_REC, W, n_old=8, n_overflow=8)
    ps = convert.oracle_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    ptab = _port_table(jtab)
    for r, jb in enumerate(si_batches):
        jout = jsi.run_round(jtab, jo, js, jb, make_compute(jb))
        pb = _port_batch(jb)
        pout = si.run_round(ptab, po, ps, pb, _port_compute(pb),
                            fused_commit=fused)
        for f in ("committed", "snapshot_miss", "read_data"):
            _eq(getattr(jout, f), getattr(pout, f), f"round {r} {f}")
        for f in ("ops", "vis"):
            for g, a, b in zip(getattr(pout, f)._fields, getattr(jout, f),
                               getattr(pout, f)):
                _eq(a, b, f"round {r} {f}.{g}")
        jtab, js = jmvcc.version_mover(jout.table), jout.oracle_state
        ptab, ps = mvcc.version_mover(pout.table), pout.oracle_state
        _eq_oracle(js, ps, f"round {r} oracle state")
    _eq_table(jtab, ptab, "table")


# ------------------------------------------------------ si.run_rounds ----
def _fixed_compute_j(rh, rd, vec):
    return rd[:, :WS, :] + 1


def _fixed_compute_p(rh, rd, vec):
    return rd[:, :WS, :] + 1


@pytest.mark.parametrize("staleness", [0, 2])
@pytest.mark.parametrize("name", ["vector", "naive", "compressed_x4"])
def test_run_rounds_matches_reference(name, staleness, si_batches):
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *si_batches)
    jo, po = SI_ORACLES[name](jts), SI_ORACLES[name](ts)
    jtab = jmvcc.init_table(N_REC, W, n_old=8, n_overflow=8)
    jtab, js, jc, jm = jsi.run_rounds(
        jtab, jo, jo.init(), lambda key, r: jax.tree.map(
            lambda x: x[r], stacked), _fixed_compute_j, ROUNDS,
        jax.random.PRNGKey(0), staleness=staleness)
    pbatches = [_port_batch(b) for b in si_batches]
    for fused in (False, True):
        ptab = _port_table(jmvcc.init_table(N_REC, W, n_old=8, n_overflow=8))
        ptab, ps, pc, pm = si.run_rounds(
            ptab, po, po.init(device="cpu"), lambda r: pbatches[r],
            _fixed_compute_p, ROUNDS, staleness=staleness,
            fused_commit=fused, batched_probe=fused)
        _eq(jc, pc, f"committed fused={fused}")
        _eq(jm, pm, f"missed fused={fused}")
        _eq_oracle(js, ps, f"state fused={fused}")
        _eq_table(jtab, ptab, f"table fused={fused}")
    assert np.asarray(jc).any() and not np.asarray(jc).all()


@pytest.mark.parametrize("k", [1, 2])
def test_stale_snapshot_commits_a_subset(k, si_batches):
    """From each round's shared start, a ``k``-stale snapshot
    (``staleness_window`` over the ring of made-visible vectors) commits a
    subset of what the fresh snapshot commits, and with some round more
    aborts (the reference's ``test_staleness_only_adds_aborts``)."""
    o = ts.VectorOracle(T_SI)
    state = o.init(device="cpu")
    table = _port_table(jmvcc.init_table(N_REC, W, n_old=8, n_overflow=8))
    hist = state.vec.expand(k + 1, T_SI).clone()
    extra = False
    for r, jb in enumerate(si_batches):
        b = _port_batch(jb)
        stale_tab, stale_state = _clone(table), _clone(state)
        stale = si.run_round(stale_tab, o, stale_state, b, _port_compute(b),
                             rts_vec=ts.staleness_window(hist, k))
        fresh = si.run_round(table, o, state, b, _port_compute(b))
        assert not (stale.committed & ~fresh.committed).any(), r
        extra |= bool((fresh.committed & ~stale.committed).any())
        mvcc.version_mover(table)
        hist = torch.cat([state.vec[None], hist[:-1]])
    assert extra, "staleness never added an abort"


def _clone(tup):
    return type(tup)(*(t.clone() for t in tup))


# ------------------------------------------------ the TPC-C drivers ----
MIX_CFG = dict(n_warehouses=2, customers_per_district=8, n_items=64,
               n_threads=16, orders_per_thread=16, dist_degree=50.0,
               key_addressed=True)
NO_CFG = dict(n_warehouses=2, customers_per_district=8, n_items=64,
              n_threads=8, orders_per_thread=16, dist_degree=50.0,
              key_addressed=True)
DRIVER_ORACLES = {
    "vector": lambda m, T: m.VectorOracle(T),
    "naive": lambda m, T: m.NaiveOracleAdapter(T),
    "compressed": lambda m, T: m.CompressedVectorOracle(T, 4),
    "partitioned": lambda m, T: m.PartitionedVectorOracle(T, n_parts=4),
}
MIX_ROUNDS = 6
KERNELS = dict(fused_commit=True, batched_probe=True)
DURABLE = dict(gc_interval=2, max_txn_time=1)
_REF = {}


def _ref_start(name, kw, capacity=None):
    """The reference's loaded state under oracle ``name`` (numpy leaves)."""
    jcfg = jtpcc.TPCCConfig(**kw)
    jo = DRIVER_ORACLES[name](jts, jcfg.n_threads) if capacity is None \
        else jts.NaiveOracleAdapter(jcfg.n_threads, capacity)
    lay, jst = jtpcc.init_tpcc(jcfg, jo, jax.random.PRNGKey(0))
    return jcfg, jo, lay, jst


def _ref_mixed(name, n_rounds=MIX_ROUNDS, capacity=None, durable=False):
    """The reference's mix under oracle ``name`` from its loaded state, run
    once: the start state and each sub-round's output (numpy), the final
    state, the statistics and, with ``durable``, the journal."""
    key = (name, n_rounds, capacity, durable)
    if key not in _REF:
        jcfg, jo, lay, jst = _ref_start(name, MIX_CFG, capacity)
        start = jax.tree.map(np.asarray, jst)
        log, kw = [], {}
        if durable:
            kw = dict(DURABLE, journal=jtpcc.make_journal(
                jcfg, jo, capacity_rounds=n_rounds + 2))
        orig = {fn: getattr(jtpcc, fn) for fn in ROUND_FNS}
        try:
            for fn in ROUND_FNS:
                setattr(jtpcc, fn, _recording(jtpcc, fn, log))
            jst, js = jtpcc.run_mixed_rounds(jcfg, lay, jst, jo,
                                             jax.random.PRNGKey(1), n_rounds,
                                             mix=TEST_MIX, **kw)
        finally:
            for fn, f in orig.items():
                setattr(jtpcc, fn, f)
        _REF[key] = dict(start=start, log=log, st=jst, stats=js,
                         draws=_mixed_draws(jcfg, 1, n_rounds, None, None,
                                            TEST_MIX),
                         lay=lay, jnl=[o.journal for _, o in log if getattr(
                             o, "journal", None) is not None][-1]
                         if durable else None)
    return _REF[key]


def _port_mixed(ref, oracle, kernels, engine_fn=None, durable=False):
    """The port's mix on ``ref``'s start state and draws (over the
    servers of ``engine_fn(cfg, lay)`` when given, a journal replica a
    server)."""
    cfg = tpcc.TPCCConfig(**MIX_CFG, **(KERNELS if kernels else {}))
    st = convert.tpcc_state_from_numpy(ref["start"], "cpu")
    kw, log, S = {}, [], 2
    if engine_fn is not None:
        kw["engine"] = engine_fn(cfg, ref["lay"])
        st = tpcc.distribute_state(kw["engine"], st)
        S = kw["engine"].n_shards
    if durable:
        jnl = tpcc.make_journal(cfg, oracle,
                                capacity_rounds=len(ref["draws"]) + 2,
                                n_replicas=S, device="cpu")
        if engine_fn is not None:
            jnl = store.shard_journal(S, jnl)
        kw.update(DURABLE, journal=jnl)
    names = ROUND_FNS if engine_fn is None else ()
    orig = {fn: getattr(tpcc, fn) for fn in names}
    try:
        for fn in names:
            setattr(tpcc, fn, _recording(tpcc, fn, log))
        st, stats = tpcc.run_mixed_rounds(
            cfg, ref["lay"], st, oracle, lambda r: ref["draws"][r],
            len(ref["draws"]), device="cpu", **kw)
    finally:
        for fn, f in orig.items():
            setattr(tpcc, fn, f)
    return st, stats, log, kw.get("journal")


def _eq_mixed(ref, st, stats, log):
    if log:
        assert [n for n, _ in ref["log"]] == [n for n, _ in log]
        for i, ((n, jo), (_, po)) in enumerate(zip(ref["log"], log)):
            kind = n[:-len("_round")]
            if kind in READ_TYPES:
                _eq_readonly(jo, po, f"call {i} {n}")
            else:
                _eq_write(jo, po, WRITE_TYPES[kind], f"call {i} {n}")
    _eq_state(ref["st"], st)
    _eq_stats(ref["stats"], stats)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("name", sorted(DRIVER_ORACLES))
def test_mixed_rounds_match_reference(name, kernels):
    ref = _ref_mixed(name)
    oracle = DRIVER_ORACLES[name](ts, MIX_CFG["n_threads"])
    st, stats, log, _ = _port_mixed(ref, oracle, kernels)
    _eq_mixed(ref, st, stats, log)
    assert 0 < stats.total_commits < stats.total_attempts
    # the oracle decides visibility, never conflicts: all four designs
    # commit the same and write the same payloads
    vec = _ref_mixed("vector")
    assert ref["stats"].commits == vec["stats"].commits
    np.testing.assert_array_equal(np.asarray(ref["st"].nam.table.cur_data),
                                  np.asarray(vec["st"].nam.table.cur_data))


@pytest.mark.parametrize("name", ["naive", "compressed"])
def test_durable_mix_matches_reference(name):
    """GC every 2 rounds and the journal on one server, which the
    reference runs under both oracles."""
    ref = _ref_mixed(name, durable=True)
    oracle = DRIVER_ORACLES[name](ts, MIX_CFG["n_threads"])
    st, stats, log, jnl = _port_mixed(ref, oracle, True, durable=True)
    _eq_mixed(ref, st, stats, log)
    _eq_journal(ref["jnl"], jnl)
    assert stats.gc_sweeps == MIX_ROUNDS // DURABLE["gc_interval"]


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("name", sorted(DRIVER_ORACLES))
def test_neworder_rounds_match_reference(name, kernels):
    jcfg, jo, lay, jst = _ref_start(name, NO_CFG)
    start = jax.tree.map(np.asarray, jst)
    jst, js = jtpcc.run_neworder_rounds(jcfg, lay, jst, jo,
                                        jax.random.PRNGKey(5), 4)
    cfg = tpcc.TPCCConfig(**NO_CFG, **(KERNELS if kernels else {}))
    draws = _neworder_draws(jcfg, 5, 4)
    st, ps = tpcc.run_neworder_rounds(
        cfg, lay, convert.tpcc_state_from_numpy(start, "cpu"),
        DRIVER_ORACLES[name](ts, cfg.n_threads), lambda r: draws[r], 4,
        device="cpu")
    _eq_state(jst, st)
    _eq(js.committed, ps.committed, "committed")
    _eq(js.missed, ps.missed, "missed")
    for f in ("attempts", "commits", "retries", "snapshot_misses",
              "contention_aborts", "ovf_reads", "ovf_peak"):
        assert getattr(js, f) == getattr(ps, f), f
    assert tuple(js.ops) == tuple(ps.ops)
    assert 0 < ps.commits < ps.attempts


def test_naive_adapter_stalls_past_its_capacity():
    """The adapter never moves the bitmap's origin: every write sub-round
    fetches 16 timestamps, so 8 mix rounds of 16 threads (20 write
    sub-rounds here) take the counter to 320, past a capacity of 64;
    from then on every index clamps to the last bit and the read
    timestamp stays at 64. New versions turn invisible, so the run commits
    less than the vector oracle's on the same draws, and exactly what the
    reference commits."""
    ref = _ref_mixed("naive", n_rounds=8, capacity=64)
    oracle = ts.NaiveOracleAdapter(MIX_CFG["n_threads"], capacity=64)
    st, stats, log, _ = _port_mixed(ref, oracle, True)
    _eq_mixed(ref, st, stats, log)
    n_write = sum(n[:-len("_round")] in WRITE_TYPES for n, _ in log)
    gc = st.nam.oracle_state.gc
    assert n_write == 20 and int(gc.cts) == 16 * n_write == 320
    assert int(gc.rts) == int(st.nam.oracle_state.vec) == 64
    assert bool((gc.bitmap == 1).all())
    vec = _ref_mixed("vector", n_rounds=8)
    assert stats.total_commits < vec["stats"].total_commits


@pytest.mark.parametrize("in_flight", [False, True])
def test_compressed_oracle_recovers_as_the_reference_runs(in_flight):
    """The journalled, checkpointed mix under the compressed oracle with
    the memory server killed at round 3 (and intents in flight) equals the
    reference's uninterrupted run of the same oracle."""
    ref = _ref_mixed("compressed", durable=True)
    cfg = tpcc.TPCCConfig(**MIX_CFG, **KERNELS)
    oracle = ts.CompressedVectorOracle(cfg.n_threads, 4)
    st = convert.tpcc_state_from_numpy(ref["start"], "cpu")
    jnl = tpcc.make_journal(cfg, oracle, capacity_rounds=MIX_ROUNDS + 2,
                            device="cpu")
    with tempfile.TemporaryDirectory() as d:
        st, stats = tpcc.run_mixed_rounds(
            cfg, ref["lay"], st, oracle, lambda r: ref["draws"][r],
            MIX_ROUNDS, journal=jnl, checkpoint_dir=d,
            failure=tpcc.FailureInjector(kill_round=3, dead_server=0,
                                         in_flight=in_flight),
            device="cpu", **DURABLE)
    (rep,) = stats.recovery
    assert rep.replayed_entries > 0
    assert (rep.undetermined > 0) == in_flight
    _eq_state(ref["st"], st)
    _eq_stats(ref["stats"], stats)


@pytest.mark.parametrize("shard_vector,kernels,durable", [
    (False, False, False), (False, True, True), (True, True, False)])
def test_compressed_oracle_over_servers_matches_one_server(
        shard_vector, kernels, durable):
    """``CompressedVectorOracle(16, 4)`` over 4 memory servers, the vector
    replicated or partitioned (one slot a server), against the
    reference's one-server run of the same oracle."""
    S = 4
    ref = _ref_mixed("compressed", durable=durable)
    oracle = ts.CompressedVectorOracle(MIX_CFG["n_threads"], 4)
    st, stats, _, _ = _port_mixed(
        ref, oracle, kernels, durable=durable,
        engine_fn=lambda c, lay: tpcc.make_mixed_engine(
            c, lay, S, oracle, shard_vector=shard_vector,
            with_journal=durable))
    R = ref["lay"].catalog.total_records
    nam = st.nam
    st = st._replace(nam=nam._replace(
        table=mvcc.VersionedTable(*(t[:R] for t in nam.table))))
    _eq_state(ref["st"], st)
    _eq_stats(ref["stats"], stats)


class _FrozenOracle(ts.VectorOracle):
    """A vector oracle whose make-visible publishes nothing: its vector
    must stay zero whatever the commit kernel does."""

    def make_visible(self, state, tid, cts, committed=None):
        return state


@pytest.mark.parametrize("n_shards", [None, 2])
def test_kernel_leaves_another_make_visible_alone(n_shards):
    """The commit kernel (on the CPU its in-place twin) writes the
    oracle's vector only when the oracle's make-visible is the vector's
    scatter-max; otherwise it writes a scratch copy and the oracle's own
    make-visible decides, on one server and over servers."""
    T, runs = MIX_CFG["n_threads"], []
    for kernels in (False, True):
        cfg = tpcc.TPCCConfig(**MIX_CFG, **(KERNELS if kernels else {}))
        oracle = _FrozenOracle(T)
        lay, st = tpcc.init_tpcc(cfg, oracle, device="cpu")
        engine = None
        if n_shards:
            engine = tpcc.make_mixed_engine(cfg, lay, n_shards, oracle)
            st = tpcc.distribute_state(engine, st)
        draw = workload.mixed_stream(cfg, torch.Generator().manual_seed(2))
        st, stats = tpcc.run_mixed_rounds(cfg, lay, st, oracle, draw, 3,
                                          engine=engine, device="cpu")
        runs.append((st, stats))
    (st_p, stats_p), (st_k, stats_k) = runs
    assert not st_k.nam.oracle_state.vec.any()
    assert stats_k.total_attempts > 0
    _eq_stats(stats_p, stats_k)
    for a, b in zip(jax.tree.leaves(convert.tpcc_state_to_numpy(st_p)),
                    jax.tree.leaves(convert.tpcc_state_to_numpy(st_k))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ refusals ----
def test_naive_adapter_refused_over_servers():
    """The reference hands the oracle a bare ``VectorState`` over servers
    (``store.distributed_round``) and fails inside the first write
    sub-round; the port refuses the engine up front."""
    jcfg, jo, lay, jst = _ref_start("naive", MIX_CFG)
    mesh = Mesh(np.array(jax.devices()[:1]), ("mem",))
    engine = jtpcc.make_mixed_engine(jcfg, lay, mesh, "mem", jo)
    with pytest.raises(AttributeError, match="gc"):
        jtpcc.run_mixed_rounds(jcfg, lay, jtpcc.distribute_state(engine, jst),
                               jo, jax.random.PRNGKey(1), 1, mix=TEST_MIX,
                               engine=engine)
    cfg = tpcc.TPCCConfig(**MIX_CFG)
    for shard_vector in (False, True):
        with pytest.raises(ValueError, match="vector oracle"):
            tpcc.make_mixed_engine(cfg, lay, 2, ts.NaiveOracleAdapter(16),
                                   shard_vector=shard_vector)
        with pytest.raises(ValueError, match="vector oracle"):
            tpcc.make_distributed_engine(cfg, lay, 2,
                                         ts.NaiveOracleAdapter(16),
                                         shard_vector=shard_vector)


def test_naive_adapter_refused_in_recovery():
    """The reference's recovery rebuilds a bare ``VectorState`` and the
    next round fails; the port refuses the run before its first round,
    and ``recover_from_failure`` itself."""
    jcfg, jo, lay, jst = _ref_start("naive", MIX_CFG)
    start = jax.tree.map(np.asarray, jst)
    kill = dict(kill_round=0, dead_server=0, in_flight=False)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(AttributeError, match="gc"):
            jtpcc.run_mixed_rounds(
                jcfg, lay, jst, jo, jax.random.PRNGKey(1), 1, mix=TEST_MIX,
                journal=jtpcc.make_journal(jcfg, jo, capacity_rounds=4),
                checkpoint_dir=d, failure=jtpcc.FailureInjector(**kill))
    cfg = tpcc.TPCCConfig(**MIX_CFG)
    oracle = ts.NaiveOracleAdapter(cfg.n_threads)
    st = convert.tpcc_state_from_numpy(start, "cpu")
    jnl = tpcc.make_journal(cfg, oracle, capacity_rounds=4, device="cpu")
    rounds = []
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="VectorState"):
            tpcc.run_mixed_rounds(cfg, lay, st, oracle,
                                  lambda r: rounds.append(r), 2,
                                  journal=jnl, checkpoint_dir=d,
                                  failure=tpcc.FailureInjector(**kill),
                                  device="cpu")
        assert rounds == [] and int(jnl.used.sum()) == 0
        with pytest.raises(ValueError, match="VectorState"):
            tpcc.recover_from_failure(cfg, lay, st, None, jnl, d,
                                      tpcc.FailureInjector(**kill),
                                      use_gc=False)


# ------------------------------------- convert, cas and header helpers ----
def test_convert_round_trips_the_oracle_states():
    rng = np.random.default_rng(9)
    jo = jts.NaiveOracleAdapter(8, capacity=16)
    js = jo.init()
    tids = jnp.arange(8, dtype=jnp.int32)
    for _ in range(3):
        js = jo.make_visible(js, tids, jo.next_commit_ts_batch(
            js, tids, jnp.asarray(rng.random(8) < 0.5)))
    gstate = js.gc._replace(cts=jnp.asarray([0xFFFFFFF0], jnp.uint32))
    for ref in (js, gstate, jts.VectorState(vec=jnp.asarray(
            [0, 0x80000000, 0xFFFFFFFF], jnp.uint32))):
        port = convert.oracle_state_from_numpy(
            jax.tree.map(np.asarray, ref), "cpu")
        assert type(port).__name__ == type(ref).__name__
        _eq_oracle(ref, port, type(ref).__name__)
        back = convert.oracle_state_from_numpy(
            convert.oracle_state_to_numpy(port), "cpu")
        for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(back)):
            assert torch.equal(a, b)
    # inside a TPC-C state
    jcfg, _, _, jst = _ref_start("naive", NO_CFG)
    pst = convert.tpcc_state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    assert isinstance(pst.nam.oracle_state, ts.NaiveAdapterState)
    _eq_state(jst, pst)


def test_all_granted_per_txn_matches_reference():
    rng = np.random.default_rng(11)
    n_txn, Q = 6, 40
    granted = rng.random(Q) < 0.7
    active = rng.random(Q) < 0.8
    txn = rng.integers(0, n_txn, Q).astype(np.int32)
    txn[:4] = [-1, n_txn, n_txn + 3, -n_txn - 1]   # wrapped or dropped
    active[np.isin(txn, [2])] = False               # a read-only txn
    ref = jcas.all_granted_per_txn(jnp.asarray(granted), jnp.asarray(txn),
                                   n_txn, jnp.asarray(active))
    port = cas.all_granted_per_txn(torch.from_numpy(granted),
                                   torch.from_numpy(txn), n_txn,
                                   torch.from_numpy(active))
    _eq(ref, port, "all_granted_per_txn")
    assert np.asarray(ref).any() and not np.asarray(ref).all()


def test_key64_matches_reference():
    rng = np.random.default_rng(12)
    hdr = rng.integers(0, 1 << 32, (5, 3, 2), dtype=np.uint64).astype(U32)
    hdr[0, 0, 1] = 0xFFFFFFFF
    ref = np.asarray(jheader.key64(jnp.asarray(hdr))).astype(np.int64)
    port = header.key64(torch.from_numpy(np_to_i32(hdr)))
    assert port.dtype == torch.int64
    np.testing.assert_array_equal(ref, port.numpy())


def test_oracle_inits_refuse_to_run_on_the_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for oracle in (ts.GlobalCounterOracle(8), ts.NaiveOracleAdapter(4, 8),
                   ts.CompressedVectorOracle(4, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            oracle.init()
        assert oracle.init(device="cpu") is not None
