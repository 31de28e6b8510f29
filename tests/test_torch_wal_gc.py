"""The port's §5.3 GC and §6.2 WAL against ``repro.core.gc``/``wal``.

Each function of ``repro_torch.core.gc``, ``repro_torch.core.wal`` and
``mvcc.compact_overflow`` takes the same inputs as the reference's,
carried across through numpy: the cases of ``tests/test_wal_gc.py`` (a
wrapped ring that must raise, the order-key overflow, a surviving replica,
the release of every unresolved intent, unused-slot preference and
wraparound of the snapshot ring, ``reuse_only`` stalling until
``collect``), plus populated tables with thread ids past the vector and
commit stamps near 2^32. Every output is an integer, a bool or a float32
share of counts: the tolerance is exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gc as jgc, mvcc as jmvcc, \
    wal as jwal

from repro_torch import convert
from repro_torch._u32 import np_to_i32
from repro_torch.core import gc, header as hdr, mvcc, wal

from test_torch_gpu import _probe_table
from test_wal_gc import _run_workload


def _eq(ref, port, what=""):
    a = np_to_i32(np.asarray(ref))
    b = port.cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_tuple(ref, port, what=""):
    assert type(ref)._fields == type(port)._fields
    for f in port._fields:
        _eq(getattr(ref, f), getattr(port, f), f"{what}.{f}")


def _ptable(jtbl) -> mvcc.VersionedTable:
    return mvcc.VersionedTable(*(torch.from_numpy(np_to_i32(np.asarray(x)))
                                 for x in jtbl))


def _jtable(tbl: dict) -> jmvcc.VersionedTable:
    return jmvcc.VersionedTable(**{k: jnp.asarray(v) for k, v in tbl.items()})


def _pjournal(j) -> wal.Journal:
    return convert.journal_from_numpy(j, "cpu")


def _clone(x):
    return type(x)(*(t.clone() for t in x))


# ------------------------------------------------------------------ GC ----
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_overflow_matches_reference(seed):
    tbl, _ = _probe_table(seed)
    ref = jmvcc.compact_overflow(_jtable(tbl))
    port = mvcc.compact_overflow(_ptable(_jtable(tbl)))
    _eq_tuple(ref, port, "compact_overflow")
    dead = hdr.is_deleted(port.ovf_hdr)
    assert dead.any() and (~dead).any()
    again = mvcc.compact_overflow(_clone(port))
    _eq_tuple(port, again, "idempotent")


def test_take_snapshot_prefers_unused_slots_and_wraps():
    """Unused slots first, then the oldest; every step equals the
    reference's log, over two laps of the ring."""
    S = 4
    jlog = jgc.init_log(S, n_slots=2)
    log = gc.init_log(S, n_slots=2, device="cpu")
    for t in range(10, 10 + 2 * S + 1):
        v = np.array([t, 0xFFFFFFF0 + t % 7], np.uint32)
        jlog = jgc.take_snapshot(jlog, t, jnp.asarray(v))
        gc.take_snapshot(log, t, torch.from_numpy(np_to_i32(v)))
        _eq_tuple(jlog, log, f"log at {t}")
    assert (log.times >= 0).all()
    back = convert.snapshot_log_to_numpy(log)
    assert back.vecs.dtype == np.uint32 and back.times.dtype == np.int32
    np.testing.assert_array_equal(back.vecs, np.asarray(jlog.vecs))


@pytest.mark.parametrize("now,E", [(260, 100), (400, 100), (150, 60),
                                   (99, 0), (1000, 1)])
def test_safe_vector_matches_reference(now, E):
    """The uint32 max is taken on the widened values: words at and above
    2^31 (negative as int32) must win over small ones."""
    rng = np.random.RandomState(now)
    jlog = jgc.init_log(5, n_slots=6)
    for t in (100, 150, 200, 250):
        v = rng.randint(0, 1 << 32, 6, dtype=np.uint64).astype(np.uint32)
        v[t % 6] = 3
        jlog = jgc.take_snapshot(jlog, t, jnp.asarray(v))
    log = convert.snapshot_log_from_numpy(jlog, "cpu")
    _eq(jgc.safe_vector(jlog, now, E), gc.safe_vector(log, now, E),
        "safe_vector")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collect_matches_reference(seed):
    tbl, ts = _probe_table(seed)
    for safe in (ts, np.zeros_like(ts), np.full_like(ts, 0xFFFFFFFF),
                 (ts // 2).astype(np.uint32)):
        ref = jgc.collect(_jtable(tbl), jnp.asarray(safe))
        port = gc.collect(_ptable(_jtable(tbl)),
                          torch.from_numpy(np_to_i32(safe)))
        _eq_tuple(ref, port, "collect")
    doomed = hdr.is_deleted(port.ovf_hdr) \
        & ~hdr.is_deleted(_ptable(_jtable(tbl)).ovf_hdr)
    assert doomed.any()


def test_gc_round_and_reclaimable_fraction_match_reference():
    """Sweeps over the table of a few SI rounds, each snapshot, safe
    vector and truncation against the reference's, and the telemetry
    over the whole pool and its first records."""
    jtbl, jst, _ = _run_workload(n_rounds=6, n_records=8)
    tbl = _ptable(jtbl)
    jlog, log = jgc.init_log(3, n_slots=3), gc.init_log(3, 3, device="cpu")
    vec = torch.from_numpy(np_to_i32(np.asarray(jst.vec)))
    for now in range(5):
        jtbl, jlog = jgc.gc_round(jtbl, jst.vec, jlog, now, 1)
        gc.gc_round(tbl, vec, log, now, 1)
        _eq_tuple(jtbl, tbl, f"table after sweep {now}")
        _eq_tuple(jlog, log, f"log after sweep {now}")
        for n in (None, 5):
            ref = float(jgc.reclaimable_fraction(jtbl, n_records=n))
            port = gc.reclaimable_fraction(tbl, n_records=n)
            assert port.dtype == torch.float32
            assert ref == float(port), (now, n)


def _install_pair(jtbl, tbl, v):
    args = (np.array([0], np.int32), np.array([[1 << 3, v]], np.uint32),
            np.full((1, 2), v, np.int32), np.array([True]))
    jout = jmvcc.install(jtbl, *(jnp.asarray(a) for a in args))
    pout = mvcc.install(tbl, *(torch.from_numpy(np_to_i32(a))
                               for a in args))
    _eq(jout.installed, pout.installed, f"installed v{v}")
    return jout.table, pout.table


def test_version_mover_reuse_only_stalls_until_collect():
    """The reference's §5.3 discipline step by step: the mover stalls on
    live overflow versions, the next install fails, one collect and
    truncation unblocks it."""
    jtbl = jmvcc.init_table(1, 2, n_old=1, n_overflow=2)
    tbl = mvcc.init_table(1, 2, n_old=1, n_overflow=2, device="cpu")
    for v in (1, 2, 3, 4):
        jtbl, tbl = _install_pair(jtbl, tbl, v)
        jtbl = jmvcc.version_mover(jtbl, reuse_only=True)
        mvcc.version_mover(tbl, reuse_only=True)
        _eq_tuple(jtbl, tbl, f"after v{v}")
    safe = np.array([0, 1], np.uint32)
    jtbl = jmvcc.compact_overflow(jgc.collect(jtbl, jnp.asarray(safe)))
    mvcc.compact_overflow(gc.collect(tbl, torch.from_numpy(np_to_i32(safe))))
    _eq_tuple(jtbl, tbl, "after collect")
    jtbl = jmvcc.version_mover(jtbl, reuse_only=True)
    mvcc.version_mover(tbl, reuse_only=True)
    jtbl, tbl = _install_pair(jtbl, tbl, 5)
    _eq_tuple(jtbl, tbl, "after the retried install")
    assert int(tbl.ovf_next[0]) < 2
    assert 2 in hdr.commit_ts(tbl.ovf_hdr[0]).tolist()


# ----------------------------------------------------------------- WAL ----
def _append_both(j, pj, tid, ts, slots, cts, data, mask, committed, rnd,
                 seq=0):
    """One intent (and, unless ``committed`` is None, its outcome) in both
    journals, through ``pad_writes``."""
    T = len(tid)
    h = np.stack([np.broadcast_to((tid[:, None] << 3).astype(np.uint32),
                                  slots.shape),
                  np.broadcast_to(np.asarray(cts, np.uint32)[:, None],
                                  slots.shape)], -1).astype(np.uint32)
    args = (slots, h, data, mask)
    j = jwal.append_intent(
        j, jnp.asarray(tid), jnp.asarray(ts),
        *jwal.pad_writes(j, *(jnp.asarray(a) for a in args)),
        round_no=rnd, seq=seq)
    targs = [torch.from_numpy(np_to_i32(a)) for a in args]
    wal.append_intent(pj, torch.from_numpy(tid),
                      torch.from_numpy(np_to_i32(ts)),
                      *wal.pad_writes(pj, *targs), round_no=rnd, seq=seq)
    if committed is not None:
        j = jwal.append_outcome(j, jnp.asarray(tid), jnp.asarray(committed))
        wal.append_outcome(pj, torch.from_numpy(tid),
                           torch.from_numpy(committed))
    assert T == len(committed if committed is not None else tid)
    return j


def _random_journal(seed, n_threads=3, cap=4, n_slots=3, ws=3, W=2,
                    n_appends=6, n_rec=8, n_replicas=2):
    """Both journals after ``n_appends`` random sub-rounds (narrower
    write-sets padded, some threads absent, outcomes sometimes never
    written): the ring wraps when ``n_appends > cap``."""
    rng = np.random.RandomState(seed)
    j = jwal.init_journal(n_threads, cap, n_slots, ws, W,
                          n_replicas=n_replicas)
    pj = wal.init_journal(n_threads, cap, n_slots, ws, W,
                          n_replicas=n_replicas, device="cpu")
    for a in range(n_appends):
        tid = np.sort(rng.choice(n_threads, rng.randint(1, n_threads + 1),
                                 replace=False)).astype(np.int32)
        T, w = len(tid), rng.randint(1, ws + 1)
        ts = rng.randint(0, 1 << 32, n_slots, dtype=np.uint64) \
            .astype(np.uint32)
        j = _append_both(
            j, pj, tid, ts, rng.randint(0, n_rec, (T, w)).astype(np.int32),
            rng.randint(1, 50, T), rng.randint(0, 99, (T, w, W))
            .astype(np.int32), rng.rand(T, w) < 0.8,
            None if rng.rand() < 0.2 else rng.rand(T) < 0.7, a // 2, a % 2)
    return j, pj


@pytest.mark.parametrize("n_appends", [3, 4, 7])
def test_appends_match_reference(n_appends):
    j, pj = _random_journal(n_appends, n_appends=n_appends)
    _eq_tuple(j, pj, "journal")
    _eq_tuple(convert.journal_to_numpy(pj), pj, "round trip")
    for since in (None, np.asarray(j.used) - 1, np.zeros(3, np.int32)):
        jl = jwal._live_window(j, None if since is None
                               else jnp.asarray(since))
        pl = wal._live_window(pj, None if since is None
                              else torch.from_numpy(since))
        _eq(jl, pl, "live window")
        for rep in (0, 1):
            for a, b in zip(jwal.entry_status(j, rep, since=since),
                            wal.entry_status(pj, rep, since=since)):
                _eq(a, b, "entry_status")
    for a, b in zip(jwal._order_keys(j, 1), wal._order_keys(pj, 1)):
        _eq(a, b, "order keys")


def test_appends_check_widths():
    pj = wal.init_journal(2, 4, 3, 2, 2, device="cpu")
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(ValueError, match="ts_vec width"):
        wal.append_intent(pj, torch.arange(2), z(4), z(2, 2), z(2, 2, 2),
                          z(2, 2, 2), z(2, 2).bool())
    with pytest.raises(ValueError, match="pad_writes"):
        wal.append_intent(pj, torch.arange(2), z(3), z(2, 1), z(2, 1, 2),
                          z(2, 1, 2), z(2, 1).bool())
    with pytest.raises(ValueError, match="exceeds journal WS"):
        wal.pad_writes(pj, z(2, 3), z(2, 3, 2), z(2, 3, 2), z(2, 3).bool())
    with pytest.raises(ValueError, match="2\\^16"):
        wal.init_journal(2, 4, 1 << 16, 2, 2, device="cpu")


@pytest.mark.parametrize("move_versions,reuse_only",
                         [(True, False), (True, True), (False, False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_replay_random_journal_matches_reference(seed, move_versions,
                                                 reuse_only):
    """Replay of random entries (wrapped rings, absent threads, entries
    never resolved, uncommitted ones) onto a populated table, and the
    vector rebuilt from them, against the reference's."""
    j, pj = _random_journal(seed + 10, n_appends=4)
    tbl, _ = _probe_table(seed, R=8, K=2, KO=4, W=2, n_ts=3)
    kw = dict(move_versions=move_versions, reuse_only=reuse_only)
    for survivors in (None, [False, True]):
        ref = jwal.replay(j, _jtable(tbl), survivors=survivors, **kw)
        port = wal.replay(pj, _ptable(_jtable(tbl)), survivors=survivors,
                          **kw)
        _eq_tuple(ref, port, "replay")
        vec = np.array([5, 0xFFFFFFF0, 1], np.uint32)
        _eq(jwal.replay_vector(j, jnp.asarray(vec), survivors=survivors),
            wal.replay_vector(pj, torch.from_numpy(np_to_i32(vec)),
                              survivors=survivors), "replay_vector")


def test_replay_reconstructs_state_and_uses_surviving_replica():
    """The reference's workload of SI rounds, its journal carried across:
    the port's replay from a fresh table (from either replica) equals the
    reference's and reproduces the run's current versions."""
    j = jwal.init_journal(n_threads=3, capacity=8, n_slots=3, ws=1, width=2,
                          n_replicas=2)
    tbl, st, j = _run_workload(journal=j)
    pj = _pjournal(j)
    for survivors in (None, jnp.array([False, True])):
        fresh = jmvcc.init_table(8, 2, n_old=2, n_overflow=4)
        ref = jwal.replay(j, fresh, survivors=survivors)
        port = wal.replay(pj, _ptable(fresh), survivors=None
                          if survivors is None else [False, True])
        _eq_tuple(ref, port, "replay")
        _eq(tbl.cur_data, port.cur_data, "current payloads")
    with pytest.raises(ValueError, match="no surviving"):
        wal.replay(pj, _ptable(fresh), survivors=[False, False])


def test_replay_wrapped_ring_matches_reference_and_raises():
    j = jwal.init_journal(n_threads=3, capacity=4, n_slots=3, ws=1, width=2,
                          n_replicas=2)
    tbl, st, j, (ckpt_tbl, used_ckpt) = _run_workload(
        n_rounds=7, journal=j, ckpt_round=3)
    pj = _pjournal(j)
    assert int(pj.used[0]) == 7 > pj.capacity
    since = torch.from_numpy(np.array(used_ckpt))
    ref = jwal.replay(j, ckpt_tbl, since=used_ckpt)
    port = wal.replay(pj, _ptable(ckpt_tbl), since=since)
    _eq_tuple(ref, port, "replay since the checkpoint")
    _eq(tbl.cur_data, port.cur_data, "current payloads")
    fresh = _ptable(jmvcc.init_table(8, 2, n_old=2, n_overflow=4))
    with pytest.raises(ValueError, match="overwrote unreplayed"):
        wal.replay(pj, fresh)
    with pytest.raises(ValueError, match="overwrote unreplayed"):
        wal.replay_vector(pj, torch.zeros(3, dtype=torch.int32),
                          since=torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("ts_a,ts_b", [
    ([0x7FFFFFFF, 0x7FFFFFFF], [0x80000000, 0x80000000]),
    ([0xFFFFFFFE, 0x00000001], [0xFFFFFFFE, 0x00000002]),
])
def test_replay_order_key_overflow(ts_a, ts_b):
    """B's logged T dominates A's: B replays last and wins the record,
    where a wrapping uint32 sum or a sentinel-colliding key would not."""
    j = jwal.init_journal(n_threads=1, capacity=2, n_slots=2, ws=1, width=2,
                          n_replicas=1)
    pj = wal.init_journal(1, 2, 2, 1, 2, n_replicas=1, device="cpu")
    tid = np.array([0], np.int32)
    for rnd, (ts, cts, val) in enumerate([(ts_a, 1, 1), (ts_b, 2, 2)]):
        j = _append_both(j, pj, tid, np.array(ts, np.uint32),
                         np.zeros((1, 1), np.int32), [cts],
                         np.full((1, 1, 2), val, np.int32),
                         np.ones((1, 1), bool), np.array([True]), rnd)
    fresh = jmvcc.init_table(1, 2, n_old=2, n_overflow=2)
    ref = jwal.replay(j, fresh)
    port = wal.replay(pj, _ptable(fresh))
    _eq_tuple(ref, port, "replay")
    assert int(hdr.commit_ts(port.cur_hdr[0])) == 2
    assert port.cur_data[0].tolist() == [2, 2]


@pytest.mark.parametrize("move_versions", [True, False])
@pytest.mark.parametrize("n_threads", [2, 5])
def test_replay_breaks_full_ties_by_flat_index(n_threads, move_versions):
    """Entries equal on sum(T), round and sub-round that write one record:
    the port replays them in flat-index order (thread-major). The
    reference's ``jnp.lexsort`` leaves that order unspecified; on the CPU
    it gives the same, which this case would show if it did not."""
    j = jwal.init_journal(n_threads, 2, 2, 1, 2, n_replicas=1)
    pj = wal.init_journal(n_threads, 2, 2, 1, 2, n_replicas=1, device="cpu")
    tid = np.arange(n_threads, dtype=np.int32)
    j = _append_both(j, pj, tid, np.array([5, 7], np.uint32),
                     np.zeros((n_threads, 1), np.int32),
                     np.full(n_threads, 3),
                     np.repeat(tid, 2).reshape(n_threads, 1, 2),
                     np.ones((n_threads, 1), bool),
                     np.ones(n_threads, bool), 0)
    fresh = jmvcc.init_table(1, 2, n_old=2, n_overflow=2)
    ref = jwal.replay(j, fresh, move_versions=move_versions)
    port = wal.replay(pj, _ptable(fresh), move_versions=move_versions)
    _eq_tuple(ref, port, "replay")
    # the flat order installs thread 0, then 1; the mover runs only at the
    # round's end, so a third install finds its ring slot unmoved and fails
    assert port.cur_data[0].tolist() == [1, 1]


def test_install_with_an_empty_mask_writes_nothing():
    """Why replay need not issue the installs of entries it skips: an
    install whose mask is all false leaves every plane as it was."""
    tbl, _ = _probe_table(0)
    port = _ptable(_jtable(tbl))
    before = _clone(port)
    out = mvcc.install(port, torch.tensor([3, 5], dtype=torch.int32),
                       torch.ones((2, 2), dtype=torch.int32),
                       torch.ones((2, 4), dtype=torch.int32),
                       torch.zeros(2, dtype=torch.bool))
    assert not out.installed.any()
    _eq_tuple(before, port, "table")


def _lock_both(jtbl, tbl, slot, prio):
    from repro.core import cas as jcas
    from repro_torch.core import cas
    res = jcas.arbitrate(jtbl.cur_hdr, jnp.array([slot]),
                         jtbl.cur_hdr[jnp.array([slot])],
                         jnp.array([prio], jnp.uint32), jnp.array([True]))
    assert bool(res.granted[0])
    s = torch.tensor([slot], dtype=torch.int32)
    pres = cas.arbitrate(tbl.cur_hdr, s, tbl.cur_hdr[s.long()],
                         torch.tensor([prio], dtype=torch.int32),
                         torch.tensor([True]))
    assert bool(pres.granted[0])
    return jtbl._replace(cur_hdr=res.new_hdr), tbl


def test_release_abandoned_locks_scans_all_unresolved():
    """A resolved entry's lock stays; both unresolved entries of the dead
    thread release theirs; a thread that never appended releases nothing;
    every step equals the reference's."""
    jtbl = jmvcc.init_table(6, 2, n_old=2, n_overflow=2)
    tbl = _ptable(jtbl)
    j = jwal.init_journal(n_threads=2, capacity=4, n_slots=2, ws=1, width=2)
    pj = wal.init_journal(2, 4, 2, 1, 2, device="cpu")
    one = lambda tid, slot, cts, resolved: _append_both(
        j, pj, np.array([tid], np.int32), np.zeros(2, np.uint32),
        np.array([[slot]], np.int32), [cts], np.zeros((1, 1, 2), np.int32),
        np.array([[True]]), None if resolved is None
        else np.array([resolved]), 0)
    j = one(1, 1, 1, True)
    jtbl, tbl = _lock_both(jtbl, tbl, 1, 0)
    jtbl, tbl = _lock_both(jtbl, tbl, 2, 1)
    j = one(1, 2, 2, None)
    jtbl, tbl = _lock_both(jtbl, tbl, 3, 1)
    j = one(1, 3, 2, None)
    jtbl, tbl = _lock_both(jtbl, tbl, 4, 0)
    for dead in (0, 1, [0, 1]):
        ref = jwal.release_abandoned_locks(j, jtbl, dead)
        port = wal.release_abandoned_locks(pj, _clone(tbl), dead)
        _eq_tuple(ref, port, f"release for {dead}")
    assert hdr.is_locked(port.cur_hdr).tolist() == [False, True, False,
                                                    False, True, False]


def test_rereplicate_and_grow_replicas_match_reference():
    j, pj = _random_journal(3, n_appends=5, n_replicas=2)
    j = j._replace(ts_vec=j.ts_vec.at[1].set(7))      # replicas differ
    pj = _pjournal(j)
    for survivors in ([True, False], [False, True]):
        _eq_tuple(jwal.rereplicate(j, jnp.array(survivors)),
                  wal.rereplicate(_clone(pj), survivors), "rereplicate")
    _eq_tuple(jwal.grow_replicas(j, 4), wal.grow_replicas(pj, 4), "grow")
    with pytest.raises(ValueError, match="shrink"):
        wal.grow_replicas(pj, 1)
    assert wal._pick_replica(pj, 0, [False, True]) == 1
    with pytest.raises(ValueError, match="no surviving"):
        wal._pick_replica(pj, 0, [False, False])
