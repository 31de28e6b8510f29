"""The port's TPC-C over memory servers (``tpcc.make_mixed_engine``: the
servers a leading shard axis on one device) against the reference's
single-server drivers on the same converted draws.

The cases are those of ``tests/_distributed_equiv_check.py`` (8
warehouses, 8 customers a district, 64 items, 16 threads, 4 rounds,
``dist_degree`` 30, GC every round with E = 1) in both layouts at 2 and 3
servers, the vector partitioned: the new-order driver and the mix (with
the plain commit, and with the kernel flags, which on the CPU run the
plain twins, the decide-only one included), and the key-addressed mix at
2 servers. Held exactly: every state leaf of the real records and vector
slots, every run statistic, and the locality share, which the reference
measures here with the servers' placement put in its driver. Then the
journalled, checkpointed mix: a server killed (server 0 and the last)
with intents in flight and recovered, against the port's uninterrupted
run over the servers and the reference's single-server one; and online
scale-out 2 → 4 and 3 → 5 against the run born on the larger count, with
the moved slots and buckets the reference's functions count.
"""
import functools
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashtable as jht, locality as jlocality
from repro.core.tsoracle import VectorOracle as JOracle
from repro.db import tpcc as jtpcc, workload as jworkload

from repro_torch import convert
from repro_torch.core import locality, mvcc, store, wal
from repro_torch.core.tsoracle import PartitionedVectorOracle
from repro_torch.db import tpcc

from test_torch_durability import _eq_journal, _eq_stats, _resolved_entries
from _torch_tpcc_common import _conv
from test_torch_tpcc import _eq, _eq_state

CFG = dict(n_warehouses=8, customers_per_district=8, n_items=64,
           n_threads=16, orders_per_thread=16, dist_degree=30.0)
T = CFG["n_threads"]
ROUNDS = 4
GC = dict(gc_interval=1, max_txn_time=1)
DURABLE_GC = dict(gc_interval=2, max_txn_time=1)
KILL_ROUND = GROW_ROUND = 3
LAYOUTS = ("table_major", "warehouse_major")
KERNELS = dict(fused_commit=True, batched_probe=True)


def _cfgs(layout, **kw):
    return jtpcc.TPCCConfig(layout=layout, **CFG, **kw), \
        tpcc.TPCCConfig(layout=layout, **CFG, **kw)


def _draws(jcfg, gen, seed, n_rounds, home):
    """The reference driver's per-round draws (its key splits), converted."""
    logits = jworkload.zipf_logits(jcfg.n_items, jcfg.skew_alpha)
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        out.append(_conv(gen(sub, jcfg.n_threads, jcfg.n_warehouses,
                             jcfg.n_items, jcfg.customers_per_district, home,
                             jcfg.dist_degree, logits)))
    return out


def _mesh_locality(S, R):
    """The reference's locality module with the placement of ``S`` servers
    in place of its single-server one: its driver then measures the
    share the mesh run must report."""
    shim = types.SimpleNamespace(**vars(jlocality))
    shim.Placement = lambda n_servers, shard_records: jlocality.Placement(
        n_servers=S, shard_records=-(-R // S))
    return shim


@functools.lru_cache(maxsize=None)
def _start(layout, key_addressed=False):
    """The reference's loaded state (numpy leaves) and its layout."""
    jcfg, _ = _cfgs(layout, key_addressed=key_addressed)
    lay, jst = jtpcc.init_tpcc(jcfg, JOracle(T), jax.random.PRNGKey(0))
    return lay, jax.tree.map(np.asarray, jst)


def _deployed(layout, S, cfg, journal_rounds=0):
    """The port's loaded state over ``S`` servers (vector partitioned), its
    engine and, with ``journal_rounds``, a journal of a replica a
    server."""
    lay, jst = _start(layout, cfg.key_addressed)
    oracle = PartitionedVectorOracle(T, n_parts=S)
    engine = tpcc.make_mixed_engine(cfg, lay, S, oracle, shard_vector=True,
                                    with_journal=journal_rounds > 0)
    st = tpcc.distribute_state(
        engine, convert.tpcc_state_from_numpy(jst, "cpu"))
    jnl = store.shard_journal(S, tpcc.make_journal(
        cfg, oracle, capacity_rounds=journal_rounds, n_replicas=S,
        device="cpu")) if journal_rounds else None
    return lay, oracle, engine, st, jnl


def _unplaced(st, R):
    """The port's state trimmed to the real records and vector slots."""
    nam = st.nam
    return st._replace(nam=nam._replace(
        table=mvcc.VersionedTable(*(t[:R] for t in nam.table)),
        oracle_state=nam.oracle_state._replace(vec=nam.oracle_state.vec[:T])))


_REF = {}


def _ref(kind, layout, S=None, mode=None, key_addressed=False):
    """The reference's single-server run, made once: ``kind`` is
    ``neworder``, ``mixed`` or ``durable`` (the journalled, checkpointed
    mix); ``S`` and ``mode`` set the locality measurement."""
    key = (kind, layout, S, mode, key_addressed)
    if key not in _REF:
        jcfg, _ = _cfgs(layout, key_addressed=key_addressed)
        lay, jst = _start(layout, key_addressed)
        st = jax.tree.map(jnp.asarray, jst)
        home = jlocality.thread_homes(T, jcfg.n_warehouses)
        with pytest.MonkeyPatch.context() as mp:
            if S is not None:
                mp.setattr(jtpcc, "locality",
                           _mesh_locality(S, lay.catalog.total_records))
            if kind == "neworder":
                out = jtpcc.run_neworder_rounds(
                    jcfg, lay, st, JOracle(T), jax.random.PRNGKey(1), ROUNDS,
                    home_w=home, locality_mode=mode, **GC)
            elif kind == "mixed":
                out = jtpcc.run_mixed_rounds(
                    jcfg, lay, st, JOracle(T), jax.random.PRNGKey(9), ROUNDS,
                    home_w=home, locality_mode=mode, **GC)
            else:
                log, jnl = [], jtpcc.make_journal(
                    jcfg, JOracle(T), capacity_rounds=ROUNDS + 2)
                for name in ("neworder_round", "payment_round",
                             "delivery_round"):
                    fn = getattr(jtpcc, name)

                    def rec(*a, _fn=fn, **k):
                        o = _fn(*a, **k)
                        log.append(o.journal)
                        return o
                    mp.setattr(jtpcc, name, rec)
                with tempfile.TemporaryDirectory() as d:
                    out = jtpcc.run_mixed_rounds(
                        jcfg, lay, st, JOracle(T), jax.random.PRNGKey(9),
                        ROUNDS, home_w=home, journal=jnl, checkpoint_dir=d,
                        **DURABLE_GC)
                out = out + (log[-1],)
        _REF[key] = out
    return _REF[key]


def _home(cfg):
    return locality.thread_homes(T, cfg.n_warehouses, device="cpu")


def _jhome(cfg):
    return jlocality.thread_homes(T, cfg.n_warehouses)


# ---------------------------------------------------------------- drivers --
@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_neworder_driver_over_servers_matches_single_server(layout, S):
    jcfg, cfg = _cfgs(layout)
    jst, js = _ref("neworder", layout, S, "aware")
    draws = _draws(jcfg, jworkload.gen_neworder, 1, ROUNDS, _jhome(jcfg))
    lay, oracle, engine, st, _ = _deployed(layout, S, cfg)
    st, ps = tpcc.run_neworder_rounds(
        cfg, lay, st, oracle, lambda r: draws[r], ROUNDS, home_w=_home(cfg),
        engine=engine, locality_mode="aware", device="cpu", **GC)
    _eq_state(jst, _unplaced(st, lay.catalog.total_records))
    _eq(js.committed, ps.committed, "committed")
    _eq(js.missed, ps.missed, "missed")
    for f in ps._fields:
        if f not in ("committed", "missed"):
            assert getattr(js, f) == getattr(ps, f), f
    assert ps.commits > 0 and ps.gc_sweeps == ROUNDS
    assert 0.0 < ps.local_fraction <= 1.0


MIX_CASES = [(layout, S, kernels) for layout in LAYOUTS for S in (2, 3)
             for kernels in (False, True)]


@pytest.mark.parametrize(
    "layout,S,kernels", MIX_CASES,
    ids=[f"{c[0]}-S{c[1]}-{'kernels' if c[2] else 'plain'}"
         for c in MIX_CASES])
def test_mixed_driver_over_servers_matches_single_server(layout, S,
                                                         kernels):
    jcfg, cfg = _cfgs(layout, **(KERNELS if kernels else {}))
    jst, js = _ref("mixed", layout, S, "oblivious")
    draws = _draws(jcfg, jworkload.gen_mixed, 9, ROUNDS, _jhome(jcfg))
    lay, oracle, engine, st, _ = _deployed(layout, S, cfg)
    st, ps = tpcc.run_mixed_rounds(
        cfg, lay, st, oracle, lambda r: draws[r], ROUNDS, home_w=_home(cfg),
        engine=engine, locality_mode="oblivious", device="cpu", **GC)
    _eq_state(jst, _unplaced(st, lay.catalog.total_records))
    _eq_stats(js, ps)
    assert all(ps.attempts[n] > 0 for n in ps.attempts), ps.attempts
    assert ps.commits["neworder"] > 0 and ps.commits["payment"] > 0
    assert ps.gc_sweeps == ROUNDS and 0.0 < ps.local_fraction <= 1.0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_key_addressed_mix_over_servers_matches_single_server(layout):
    """The §5.2 directory partitioned over 2 servers, resolved by
    ``lookup_shard`` on each and the sum, with the kernel flags."""
    jcfg, cfg = _cfgs(layout, key_addressed=True, **KERNELS)
    jst, js = _ref("mixed", layout, 2, "aware", key_addressed=True)
    draws = _draws(jcfg, jworkload.gen_mixed, 9, ROUNDS, _jhome(jcfg))
    lay, oracle, engine, st, _ = _deployed(layout, 2, cfg)
    assert engine.n_dir_buckets == st.directory.n_buckets > 0
    st, ps = tpcc.run_mixed_rounds(
        cfg, lay, st, oracle, lambda r: draws[r], ROUNDS, home_w=_home(cfg),
        engine=engine, locality_mode="aware", device="cpu", **GC)
    _eq_state(jst, _unplaced(st, lay.catalog.total_records))
    _eq_stats(js, ps)
    assert ps.ops["neworder"].record_reads > \
        _ref("mixed", layout, 2, "oblivious")[1].ops["neworder"].record_reads


# ----------------------------------------------------- journal, recovery --
def _durable_draws(layout):
    jcfg, _ = _cfgs(layout)
    return _draws(jcfg, jworkload.gen_mixed, 9, ROUNDS, _jhome(jcfg))


def _durable_run(layout, S, cfg=None, **kw):
    """The journalled, checkpointed mix over ``S`` servers (a state, its
    statistics and the journal it ended with)."""
    cfg = cfg or _cfgs(layout)[1]
    lay, oracle, engine, st, jnl = _deployed(layout, S, cfg, ROUNDS + 2)
    draws = _durable_draws(layout)
    out = {}
    scale_out = tpcc.scale_out

    def keep(*a, **k):          # the grown journal replaces the caller's
        res = scale_out(*a, **k)
        out["journal"] = res[1]
        return res
    with tempfile.TemporaryDirectory() as d, pytest.MonkeyPatch.context() \
            as mp:
        mp.setattr(tpcc, "scale_out", keep)
        st, ms = tpcc.run_mixed_rounds(
            cfg, lay, st, oracle, lambda r: draws[r], ROUNDS,
            home_w=_home(cfg), engine=engine, journal=jnl, checkpoint_dir=d,
            device="cpu", **DURABLE_GC, **kw)
    return lay, st, ms, out.get("journal", jnl)


@functools.lru_cache(maxsize=None)
def _uninterrupted(layout, S):
    return _durable_run(layout, S)


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_journalled_mix_over_servers_matches_single_server(layout, S):
    """Every server's replica equals the reference's journal."""
    jst, js, jj = _ref("durable", layout)
    lay, st, ps, pj = _uninterrupted(layout, S)
    _eq_state(jst, _unplaced(st, lay.catalog.total_records))
    _eq_stats(js, ps)
    for r in range(S):
        _eq_journal(jj, wal.Journal(*(x[r:r + 1].expand(
            (2,) + x.shape[1:]) if f in wal.ENTRY_FIELDS else x
            for f, x in zip(wal.Journal._fields, pj))), f"replica {r}")
    assert ps.gc_sweeps == ROUNDS // DURABLE_GC["gc_interval"]


def _lose(dead, Rs):
    """``recover_from_failure`` after the dead server's view and journal
    replica are overwritten: its memory is really lost."""
    recover = tpcc.recover_from_failure

    def lost(cfg, lay, st, engine, jnl, *a, **k):
        for t in store.shard_view(st.nam.table, dead, Rs):
            t.fill_(-1)
        for f in wal.ENTRY_FIELDS:
            getattr(jnl, f)[dead].fill_(True if getattr(jnl, f).dtype
                                        == torch.bool else -1)
        return recover(cfg, lay, st, engine, jnl, *a, **k)
    return lost


KILL_CASES = [(layout, S, dead) for layout in LAYOUTS for S in (2, 3)
              for dead in (0, S - 1)]


@pytest.mark.parametrize("layout,S,dead", KILL_CASES,
                         ids=[f"{c[0]}-S{c[1]}-dead{c[2]}"
                              for c in KILL_CASES])
def test_killed_server_recovers_to_the_uninterrupted_runs(layout, S, dead):
    """A server killed at round 3 with intents in flight, its view and
    replica overwritten, recovered from the checkpoint and the surviving
    replicas: the state, the statistics and the resolved journal entries
    equal the uninterrupted run over the servers and the reference's
    single-server run."""
    lay, st_u, ms_u, jnl_u = _uninterrupted(layout, S)
    cfg = _cfgs(layout)[1]
    Rs = -(-lay.catalog.total_records // S)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpcc, "recover_from_failure", _lose(dead, Rs))
        _, st, ms, jnl = _durable_run(
            layout, S, cfg, failure=tpcc.FailureInjector(
                kill_round=KILL_ROUND, dead_server=dead))
    for a, b in zip(st_u.nam.table, st.nam.table):
        assert torch.equal(a, b)
    assert torch.equal(st_u.nam.oracle_state.vec, st.nam.oracle_state.vec)
    jst, js, _ = _ref("durable", layout)
    _eq_state(jst, _unplaced(st, lay.catalog.total_records))
    _eq_stats(js, ms)
    _eq_stats(ms_u, ms)
    (rep,) = ms.recovery
    assert rep.dead_server == dead and rep.checkpoint_round < KILL_ROUND
    assert rep.replayed_entries > 0 and rep.undetermined > 0
    for f in wal.ENTRY_FIELDS:
        x = getattr(jnl, f)
        assert bool((x == x[:1]).all()), f
    (eu, uu), (ek, uk) = _resolved_entries(jnl_u), _resolved_entries(jnl)
    assert uu == 0 and uk == rep.undetermined
    for f, a, b in zip(wal.ENTRY_FIELDS, eu, ek):
        assert torch.equal(a, b), f


# ----------------------------------------------------------- scale-out --
GROW_CASES = [("table_major", 2, 4, False), ("warehouse_major", 2, 4, False),
              ("table_major", 3, 5, False), ("warehouse_major", 3, 5, False),
              ("table_major", 2, 4, True)]


@pytest.mark.parametrize(
    "layout,old,new,key_addressed", GROW_CASES,
    ids=[f"{c[0]}-{c[1]}to{c[2]}{'-key' if c[3] else ''}"
         for c in GROW_CASES])
def test_scale_out_equals_the_run_born_large(layout, old, new,
                                             key_addressed):
    """Grown from ``old`` to ``new`` servers at round 3: the state equals
    the run born on ``new`` (real records and slots; the padding differs)
    and the reference's single-server run, the statistics equal, the
    journal has a replica a server, and the moved slots and buckets are
    what the reference's functions count."""
    cfg = _cfgs(layout, key_addressed=key_addressed)[1]
    lay, st_b, ms_b, jnl_b = _durable_run(layout, new, cfg)
    _, st, ms, jnl = _durable_run(
        layout, old, cfg, growth=tpcc.MeshGrowth(GROW_ROUND, new))
    R = lay.catalog.total_records
    for a, b in zip(_unplaced(st_b, R).nam.table, _unplaced(st, R).nam.table):
        assert torch.equal(a, b)
    assert st.nam.table.n_records == -(-R // new) * new
    assert torch.equal(st.nam.oracle_state.vec, st_b.nam.oracle_state.vec)
    if not key_addressed:
        jst, js, _ = _ref("durable", layout)
        _eq_state(jst, _unplaced(st, R))
        _eq_stats(js, ms, skip=("growth",))
    _eq_stats(ms_b, ms, skip=("growth",))
    assert jnl.n_replicas == new
    for f, a, b in zip(wal.Journal._fields, jnl_b, jnl):
        assert torch.equal(a, b), f
    (rep,) = ms.growth
    assert (rep.old_shards, rep.new_shards, rep.grow_round) == \
        (old, new, GROW_ROUND)
    assert rep.checkpoint_round < GROW_ROUND and rep.replayed_entries > 0
    placements = [jlocality.Placement(k, -(-R // k)) for k in (old, new)]
    assert rep.moved_slots == int(jnp.sum(jlocality.moved_slots(
        *placements, R))) > 0
    B = tpcc.directory_buckets(cfg, lay) if key_addressed else 0
    assert rep.moved_buckets == (int(jnp.sum(jht.moved_buckets(
        B, old, new))) if key_addressed else 0)
    assert not key_addressed or rep.moved_buckets > 0
