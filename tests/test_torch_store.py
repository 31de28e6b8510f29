"""The port's sharded store (the memory servers as a leading shard axis on
one device) against ``repro.core``: the partitioned directory, oracle,
locality, range-index and catalog helpers, the placement helpers, the
decide-only commit twin, and the round executors over the servers.

The round executors run at 1, 2, 3 and 8 servers (3 and 8 divide neither
the pool nor the 16 threads, so the pool and the partitioned vector carry
padding), slot- and key-addressed, with the vector replicated and
partitioned, the journal on and off, and the plain commit or the plain
decide-only twin (the kernel flags on the CPU); each is held against the
reference's single-server ``si.run_round`` on the same batch. Inputs come
from a seeded port state converted through numpy; every comparison is
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import catalog as jcat, gc as jgc, hashtable as jht, \
    locality as jlocality, mvcc as jmvcc, rangeindex as jri, si as jsi, \
    store as jstore, wal as jwal
from repro.core.tsoracle import PartitionedVectorOracle as JPartitioned, \
    VectorOracle as JOracle, VectorState as JVectorState
from repro.db import tpcc as jtpcc, workload as jworkload

from repro_torch import convert
from repro_torch._u32 import np_to_i32
from repro_torch.core import catalog, gc, hashtable as ht, locality, mvcc, \
    rangeindex as ri, si, store, wal
from repro_torch.core.tsoracle import PartitionedVectorOracle, VectorOracle
from repro_torch.db import tpcc, workload
from repro_torch.kernels.commit.ref import fused_commit_ref

from test_torch_gpu import MESH_OUT, OOB_SLOTS, _assert_leaves_equal, _t, \
    commit_case, commit_oob_case, decide_cases, mesh_commit, port_table

SMALL = dict(n_warehouses=2, customers_per_district=8, n_items=64,
             n_threads=16, orders_per_thread=16, dist_degree=50.0)
T = SMALL["n_threads"]
DIR_BUCKETS = 768          # 24 · 32: divides over 1, 2, 3 and 8 servers
SHARDS = [1, 2, 3, 8]


def _eq(ref, port, what):
    a = np_to_i32(np.asarray(ref))
    b = port.cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    if a.dtype == np.bool_ or b.dtype == np.bool_:
        a, b = a.astype(bool), b.astype(bool)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _j(t):
    """A port tensor as a JAX array of the reference's dtype."""
    return jnp.asarray(t.numpy())


def _ju32(t):
    return jnp.asarray(t.numpy().view(np.uint32))


def _jtable(tbl):
    return jmvcc.VersionedTable(*(jnp.asarray(x) for x in convert._to_np(
        tbl)))


# ---------------------------------------------------- hashtable (§5.2) ----
def _home_keys(B, homes, n_each):
    """``n_each`` keys hashing to each bucket of ``homes`` (a chain per
    home: the first claims it, the rest probe on)."""
    out = []
    k = np.arange(1, 1 << 20, dtype=np.uint64)
    h = (k * 2654435769 % (1 << 32)) % B
    for home in homes:
        out.extend(k[h == home][:n_each].tolist())
    return np.array(out, np.uint32)


def _directory(B, S, seed):
    """A directory whose chains wrap the end of the bucket array and cross
    every server boundary, with invalidated entries; plus queries (its
    keys, absent keys, keys whose chains pass the boundaries)."""
    per = B // S
    homes = [B - 2, B - 1] + [s * per - 1 for s in range(1, S)]
    keys = np.concatenate([_home_keys(B, homes, 4),
                           np.random.RandomState(seed).randint(
                               1, 1 << 31, B // 3).astype(np.uint32)])
    keys = np.unique(keys)
    d = jht.init(B)
    d, placed = jht.insert(d, jnp.asarray(keys),
                           jnp.arange(len(keys), dtype=jnp.int32),
                           max_probes=B)
    assert bool((placed >= 0).all())
    d, _ = jht.delete(d, jnp.asarray(keys[::7]))
    queries = np.concatenate([keys, _home_keys(B, homes, 6)[-S:],
                              np.array([7, 0xFFFFFFFE, 0xFFFFFFFF],
                                       np.uint32)])
    return d, queries


@pytest.mark.parametrize("S", [2, 3, 5])
def test_lookup_shard_matches_reference_and_sums_to_lookup(S):
    B = 120
    d, q = _directory(B, S, S)
    per = B // S
    tk, tv = _t(np.asarray(d.keys)), _t(np.asarray(d.vals))
    tq = _t(q)
    vals, hits = ht.lookup_shard(tk.view(S, per), tv.view(S, per), tq,
                                 [s * per for s in range(S)], B,
                                 max_probes=B)
    for s in range(S):
        jv, jh = jht.lookup_shard(d.keys[s * per:(s + 1) * per],
                                  d.vals[s * per:(s + 1) * per],
                                  jnp.asarray(q), s * per, B, max_probes=B)
        v1, h1 = ht.lookup_shard(tk[s * per:(s + 1) * per],
                                 tv[s * per:(s + 1) * per], tq, s * per, B,
                                 max_probes=B)
        _eq(jv, vals[s], f"vals of server {s}")
        _eq(jh, hits[s], f"hits of server {s}")
        assert torch.equal(v1, vals[s]) and torch.equal(h1, hits[s])
    # the sum over the servers is lookup, the port's and the reference's
    vsum, khit = vals.sum(0, dtype=torch.int32), hits.any(0)
    found = khit & (vsum >= 0)
    wv, wf = ht.lookup(ht.HashTable(tk, tv), tq, max_probes=B)
    jv, jf = jht.lookup(d, jnp.asarray(q), max_probes=B)
    _eq(jf, found, "found")
    assert torch.equal(found, wf)
    _eq(jnp.where(jf, jv, -1), torch.where(found, vsum, -1), "vals")
    # the chains did wrap and cross servers, and some entries are deleted
    home = ht._hash(tq, B)
    # one server at most holds a key (0xFFFFFFFF's key+1 is the empty
    # marker, which every server holds)
    assert bool(((hits.sum(0) <= 1) | (tq == -1)).all())
    crossed = (hits.to(torch.int64).argmax(0) != home // per) & khit
    assert crossed.any() and (khit & (vsum < 0)).any() and (~khit).any()


def test_delete_partition_of_and_moved_buckets_match_reference():
    d, q = _directory(96, 4, 0)
    keys = q[:40]
    jd, jf = jht.delete(d, jnp.asarray(keys[::3]))
    td, tf = ht.delete(ht.HashTable(_t(np.asarray(d.keys)),
                                    _t(np.asarray(d.vals))), _t(keys[::3]))
    _eq(jf, tf, "found")
    _eq(jd.vals, td.vals, "vals")
    _eq(jd.keys, td.keys, "keys")
    for B, S in ((96, 4), (100, 3), (64, 5)):
        _eq(jht.partition_of(jnp.asarray(q), B, S),
            ht.partition_of(_t(q), B, S), "partition_of")
        for new in (S + 1, 2 * S):
            _eq(jht.moved_buckets(B, S, new), ht.moved_buckets(B, S, new),
                "moved_buckets")


# ------------------------------------------------ oracle, locality, ... ----
@pytest.mark.parametrize("n_threads,n_parts", [(16, 4), (16, 3), (7, 5)])
def test_partitioned_oracle_matches_reference(n_threads, n_parts):
    jo, po = JPartitioned(n_threads, n_parts), \
        PartitionedVectorOracle(n_threads, n_parts)
    assert (jo.n_parts, jo.part_size, jo.n_slots) == \
        (po.n_parts, po.part_size, po.n_slots)
    slots = np.arange(n_threads)
    _eq(jo.part_of_slot(slots), po.part_of_slot(torch.from_numpy(slots)),
        "part_of_slot")
    rng = np.random.RandomState(n_parts)
    hist = rng.randint(0, 1 << 31, (5, n_threads)).astype(np.uint32)
    rop = rng.randint(0, 5, n_parts).astype(np.int32)
    _eq(jo.read_partitioned(jnp.asarray(hist), jnp.asarray(rop)),
        po.read_partitioned(_t(hist), _t(rop)), "read_partitioned")


def test_locality_helpers_match_reference():
    for old, new, n in ((2, 4, 101), (3, 5, 4982), (4, 8, 64)):
        jp = [jlocality.Placement(k, -(-n // k)) for k in (old, new)]
        pp = [locality.Placement(k, -(-n // k)) for k in (old, new)]
        _eq(jlocality.moved_slots(*jp, n), locality.moved_slots(*pp, n),
            "moved_slots")
    homes = np.arange(40, dtype=np.int32)
    for wps in (1, 3, 50):
        _eq(jlocality.route_home(jnp.asarray(homes), wps),
            locality.route_home(torch.from_numpy(homes), wps), "route_home")
    for pct in (0.0, 10.0, 30.0, 100.0, 250.0):
        for kw in ({}, dict(items_remote_when_distributed=0.5,
                            accesses_home=20.0)):
            assert jlocality.expected_local_fraction(pct, **kw) == \
                locality.expected_local_fraction(pct, **kw)


@pytest.mark.parametrize("n,space", [(4, 1000), (3, 100), (7, 12345),
                                     (5, (1 << 31) - 5)])
def test_partition_bounds_match_reference(n, space):
    for a, b in zip(jri.partition_bounds(n, space),
                    ri.partition_bounds(n, space)):
        _eq(a, b, "bounds")


def test_catalog_versioning_matches_reference():
    jc, pc = jcat.Catalog(n_servers=4), catalog.Catalog(n_servers=4)
    for c in (jc, pc):
        c.create_table("a", count=100, width=4)
        c.create_table("b", count=50, width=8)
    js, ps = jc.init_state(), pc.init_state(device="cpu")
    _eq(js.version, ps.version, "init")
    jcached, pcached = js, ps
    for name in ("b", "a", "b", "b"):
        js, ps = jc.alter(js, name), pc.alter(ps, name)
        _eq(js.version, ps.version, f"alter {name}")
        _eq(jc.needs_refresh(js, jcached), pc.needs_refresh(ps, pcached),
            "needs_refresh")
    assert not pc.needs_refresh(ps, ps).any()
    wrapped = catalog.CatalogState(version=torch.full((4,), -1,
                                                      dtype=torch.int32))
    assert int(pc.alter(wrapped, "a").version[pc.server_of("a")]) == 0


def test_allocate_matches_reference():
    jext = jstore.ExtendState(cursor=jnp.zeros((4, 2), jnp.int32))
    pext = store.ExtendState(cursor=torch.zeros((4, 2), dtype=torch.int32))
    for tid, region, n in ((0, 0, 3), (2, 1, 5), (0, 0, 2), (3, 1, 1)):
        jext, jfirst = jstore.allocate(jext, tid, region, n, 100, 10, 4)
        pext, pfirst = store.allocate(pext, tid, region, n, 100, 10, 4)
        assert int(jfirst) == int(pfirst)
        _eq(jext.cursor, pext.cursor, "cursor")


# ------------------------------------------------------------ placement ----
@pytest.fixture(scope="module")
def aged():
    """The small pool after six new-order rounds (its rings and overflow
    hold versions), and a directory of its item, stock and customer keys
    over ``DIR_BUCKETS`` buckets."""
    cfg = tpcc.TPCCConfig(**SMALL)
    oracle = VectorOracle(T)
    lay, st = tpcc.init_tpcc(cfg, oracle, device="cpu")
    st, _ = tpcc.run_neworder_rounds(
        cfg, lay, st, oracle,
        workload.neworder_stream(cfg, torch.Generator().manual_seed(1)), 6,
        device="cpu")
    full = tpcc.build_tpcc_directory(
        dataclasses.replace(cfg, key_addressed=True), lay, device="cpu")
    used = full.keys != 0
    keys = (full.keys[used].to(torch.int64) - 1).to(torch.int32)
    directory = store.build_directory(keys, full.vals[used], DIR_BUCKETS,
                                      max_probes=tpcc.DIR_PROBES)
    return cfg, lay, st, directory


@pytest.mark.parametrize("S", [2, 3, 5])
def test_pad_table_pad_vector_and_shard_logs_match_reference(aged, S):
    _, lay, st, _ = aged
    jtbl = _jtable(st.nam.table)
    jp, jn = jstore.pad_table(jtbl, S)
    pp, pn = store.pad_table(st.nam.table, S)
    assert jn == pn == -(-lay.catalog.total_records // S) * S
    for f in pp._fields:
        _eq(getattr(jp, f), getattr(pp, f), f)
    assert store.shard_table(S, pp) is pp
    for n in (16, 17, 5):
        v = np.arange(n, dtype=np.uint32) * 2654435761
        jv, jn = jstore.pad_vector(jnp.asarray(v), S)
        pv, pn = store.pad_vector(_t(v), S)
        assert jn == pn
        _eq(jv, pv, "pad_vector")
        _eq(jv, store.shard_vector(S, _t(v)), "shard_vector")
        gathered = store.gather_vector(pv, n)
        assert torch.equal(gathered, _t(v))
        # a view: the servers' write-backs through it land in the parts
        assert gathered.data_ptr() == pv.data_ptr()
    jl, pl = jstore.init_shard_logs(S, 4, T), \
        store.init_shard_logs(S, 4, T, device="cpu")
    _eq(jl.times, pl.times, "times")
    _eq(jl.vecs, pl.vecs, "vecs")
    with pytest.raises(ValueError):
        store.shard_table(S, mvcc.VersionedTable(*(t[:pn - 1] for t in pp)))
    jnl = wal.init_journal(T, 2, T, 3, 8, n_replicas=S, device="cpu")
    assert store.shard_journal(S, jnl) is jnl
    with pytest.raises(ValueError):
        store.shard_journal(S + 1, jnl)


def test_shard_view_is_a_view(aged):
    _, _, st, _ = aged
    tbl, _ = store.pad_table(st.nam.table, 3)
    Rs = tbl.n_records // 3
    v = store.shard_view(tbl, 2, Rs)
    for a, b in zip(v, tbl):
        assert a.is_contiguous() and a.shape[0] == Rs
        assert a.data_ptr() == b[2 * Rs:].data_ptr()
    v.next_write[0] += 7
    assert int(tbl.next_write[2 * Rs]) == int(v.next_write[0])


# ------------------------------------------------- decide-only twin ----
DECIDE_CASES_ALL = [name for name, _ in decide_cases()]
DECIDE_CASES = [("lattice", s) for s in (0, 1, 2)] + [
    (f"{n}{'-same_prio' if sp else ''}", (n, sp)) for sp in (False, True)
    for n in OOB_SLOTS]


@pytest.mark.parametrize("name,arg", DECIDE_CASES,
                         ids=[c[0] for c in DECIDE_CASES])
def test_decide_only_twin_writes_nothing_and_counts_the_local_fails(name,
                                                                    arg):
    case = commit_case(arg) if name == "lattice" else commit_oob_case(*arg)
    tbl, args = case
    table = port_table(tbl)
    targs = [_t(a) if a.dtype != bool else torch.from_numpy(a)
             for a in args]
    before = [t.clone() for t in table] + [targs[0].clone()]
    out = fused_commit_ref(table, *targs, decide_only=True)
    assert out.granted is None and out.committed is None \
        and out.do_install is None
    for a, b in zip(before, list(table) + [targs[0]]):
        assert torch.equal(a, b)
    full = si.commit_write_sets(port_table(tbl), *targs[1:9],
                                ext_fails=targs[11])
    assert torch.equal(out.fails, full.fails)
    jfull = jsi.commit_write_sets(
        jmvcc.VersionedTable(**{k: jnp.asarray(v) for k, v in tbl.items()}),
        *(jnp.asarray(a) for a in args[1:9]), ext_fails=jnp.asarray(args[11]))
    _eq(jfull.fails, out.fails, "fails")
    assert bool((out.fails > 0).any()) and bool((out.fails == 0).any())


# ------------------------------------------------------ round executors ----
JOURNAL_CAP = 4
NO_WS = 1 + tpcc.MAX_OL        # the new-order write-set


def _batch(cfg, lay, seed):
    """A new-order batch of the small pool with its §5.2 keys, some
    threads inactive, and its inputs."""
    kcfg = dataclasses.replace(cfg, key_addressed=True)
    inp = workload.neworder_stream(
        kcfg, torch.Generator().manual_seed(seed))(0)
    active = torch.from_numpy(np.random.RandomState(seed).rand(T) < 0.7)
    batch, keyed = tpcc._neworder_batch(kcfg, lay, inp, active)
    return inp, active, batch, keyed


def _jtuple(cls, tup, u32=()):
    return cls(*((_ju32 if f in u32 else _j)(getattr(tup, f))
                 for f in cls._fields))


def _jdirectory(d):
    return jht.HashTable(keys=_ju32(d.keys), vals=_j(d.vals))


@pytest.fixture(scope="module")
def round_ref(aged):
    """The reference's single-server ``si.run_round`` on one batch, for
    each (key-addressed, journal) pair, made once, with the install and
    release counts it hands ``si.count_ops``."""
    cfg, lay, st, directory = aged
    inp, active, batch, keyed = _batch(cfg, lay, 7)
    jinp = _jtuple(jworkload.NewOrderInputs, inp)
    cache = {}

    def get(key_on, journal_on):
        if (key_on, journal_on) not in cache:
            counts = []
            count_ops = jsi.count_ops

            def rec(*a, **k):
                counts.append((int(a[4]), int(a[5])))
                return count_ops(*a, **k)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jsi, "count_ops", rec)
                out = jsi.run_round(
                    _jtable(st.nam.table), JOracle(T),
                    JVectorState(vec=_ju32(st.nam.oracle_state.vec)),
                    _jtuple(jsi.TxnBatch, batch),
                    lambda rh, rd, v: jtpcc._neworder_new_data(rd, jinp),
                    active=_j(active),
                    directory=_jdirectory(directory) if key_on else None,
                    keyed=_jtuple(jsi.KeyedReads, keyed, ("keys",))
                    if key_on else None, dir_max_probes=tpcc.DIR_PROBES,
                    journal=jwal.init_journal(T, JOURNAL_CAP, T, NO_WS,
                                              tpcc.WIDTH)
                    if journal_on else None, journal_round=2, journal_seq=1)
            cache[key_on, journal_on] = out, counts[-1]
        return cache[key_on, journal_on]
    return (inp, active, batch, keyed), get


def _placed(st, S, part):
    """A padded copy of the pool and the vector for ``S`` servers."""
    tbl = mvcc.VersionedTable(*(t.clone() for t in st.nam.table))
    tbl = store.shard_table(S, store.pad_table(tbl, S)[0])
    vec = st.nam.oracle_state.vec.clone()
    return tbl, store.shard_vector(S, vec) if part else vec


ROUND_CASES = [(S, key_on, part, journal_on, commit) for S in SHARDS
               for key_on in (False, True) for part in (False, True)
               for journal_on in (False, True)
               for commit in ("plain", "decide")]


@pytest.mark.parametrize(
    "S,key_on,part,journal_on,commit", ROUND_CASES,
    ids=[f"S{c[0]}-{'key' if c[1] else 'slot'}-"
         f"{'part' if c[2] else 'repl'}-{'jnl' if c[3] else 'nojnl'}-{c[4]}"
         for c in ROUND_CASES])
def test_distributed_round_matches_single_server(aged, round_ref, S, key_on,
                                                 part, journal_on, commit):
    """One new-order round over ``S`` servers equals the reference's
    single-server round: outcomes, reads, every table plane of the real
    records (the padding untouched), the vector (its padding zero), the op
    and visibility accounting, the install and release counts, and every
    journal replica (each equal to the reference's)."""
    cfg, lay, st, directory = aged
    (inp, active, batch, keyed), ref = round_ref
    jout, (j_inst, j_rel) = ref(key_on, journal_on)
    oracle = PartitionedVectorOracle(T, S) if part else VectorOracle(T)
    tbl, vec = _placed(st, S, part)
    fresh = _placed(st, S, part)[0]
    fused = commit == "decide"
    round_fn, n = store.distributed_round(
        S, oracle, lambda rh, rd, v, aux: tpcc._neworder_new_data(rd, aux),
        tbl.n_records // S, shard_vector=part,
        n_dir_buckets=DIR_BUCKETS if key_on else 0,
        dir_max_probes=tpcc.DIR_PROBES, with_journal=journal_on,
        fused_commit=fused, batched_probe=fused)
    assert n == S
    kw = {}
    if journal_on:
        kw.update(journal=store.shard_journal(S, wal.init_journal(
            T, JOURNAL_CAP, T, NO_WS, tpcc.WIDTH, n_replicas=S,
            device="cpu")), round_no=2, seq=1)
    if key_on:
        kw.update(directory=store.shard_directory(S, directory),
                  read_keys=keyed.keys, key_mask=keyed.mask)
    res = round_fn(tbl, vec, batch, inp, active, **kw)
    assert res[0] is tbl and res[1] is vec and len(res) == 3 + journal_on
    out = res[2]
    R = lay.catalog.total_records
    for f in ("committed", "snapshot_miss", "read_data"):
        _eq(getattr(jout, f), getattr(out, f), f)
    for f in tbl._fields:
        _eq(getattr(jout.table, f), getattr(tbl, f)[:R], f)
        assert torch.equal(getattr(tbl, f)[R:], getattr(fresh, f)[R:])
    _eq(jout.oracle_state.vec, vec[:T], "vec")
    assert not vec[T:].any()
    ops = tpcc._dist_ops(oracle, batch, out, tbl, active,
                         keyed if key_on else None)
    for f in ops._fields:
        assert int(getattr(jout.ops, f)) == int(getattr(ops, f)), f
    vis = tpcc._dist_vis(batch, out, active)
    for f in vis._fields:
        assert int(getattr(jout.vis, f)) == int(getattr(vis, f)), f
    assert (int(out.n_installs), int(out.n_releases)) == (j_inst, j_rel)
    if journal_on:
        jj, pj = jout.journal, res[3]
        for f in wal.ENTRY_FIELDS:
            for r in range(S):
                _eq(getattr(jj, f)[0], getattr(pj, f)[r], f"{f}[{r}]")
        _eq(jj.used, pj.used, "used")
    assert out.committed.any() and (active & ~out.committed).any()
    assert j_inst > 0 and j_rel > 0


def _read_case(st, seed, n=48):
    """Reads of random in-range slots, a third of them by customer key
    (some keys absent), masked at random."""
    rng = np.random.RandomState(seed)
    R = st.nam.table.n_records
    slots = torch.from_numpy(rng.randint(0, R, (T, n)).astype(np.int32))
    mask = torch.from_numpy(rng.rand(T, n) < 0.8)
    w, d, c = (rng.randint(0, k, (T, n)) for k in (2, 10, 9))
    keys = tpcc.customer_key(tpcc.TPCCConfig(**SMALL), torch.from_numpy(w),
                             torch.from_numpy(d), torch.from_numpy(c))
    key_mask = torch.from_numpy(rng.rand(T, n) < 0.33)
    return slots, mask, keys, key_mask


@pytest.mark.parametrize("part", [False, True], ids=["repl", "part"])
@pytest.mark.parametrize("key_on", [False, True], ids=["slot", "key"])
@pytest.mark.parametrize("S", SHARDS)
def test_distributed_readonly_round_matches_single_server(aged, S, key_on,
                                                          part):
    """Snapshot reads over ``S`` servers equal the reference's
    single-server read-only path (``lookup`` + ``read_visible``, a miss
    reads as not found) and write nothing."""
    _, _, st, directory = aged
    slots, mask, keys, key_mask = _read_case(st, S)
    tbl, vec = _placed(st, S, part)
    before = [t.clone() for t in tbl] + [vec.clone()]
    ro_fn = store.distributed_readonly_round(
        S, tbl.n_records // S, n_dir_buckets=DIR_BUCKETS if key_on else 0,
        dir_max_probes=tpcc.DIR_PROBES)
    kw = dict(directory=directory, read_keys=keys,
              key_mask=key_mask) if key_on else {}
    out = ro_fn(tbl, vec, slots, mask, **kw)
    for a, b in zip(before, list(tbl) + [vec]):
        assert torch.equal(a, b)
    jst = type("S", (), {})()
    jst.nam = type("N", (), {"table": _jtable(st.nam.table)})()
    jst.directory = _jdirectory(directory)
    jdata, jfound, jcur = jtpcc._snapshot_read(
        jst, None, _ju32(st.nam.oracle_state.vec), _j(slots), _j(mask),
        _ju32(keys) if key_on else None, _j(key_mask) if key_on else None)
    _eq(jdata, out.read_data, "read_data")
    _eq(jnp.asarray(jfound) | ~_j(mask), out.found, "found")
    _eq(jcur, out.from_current, "from_current")
    assert (~out.found).any() and out.from_current.any()


@pytest.mark.parametrize("part", [False, True], ids=["repl", "part"])
@pytest.mark.parametrize("S", [2, 3, 5])
def test_distributed_gc_round_matches_single_server(aged, S, part):
    """Every server's GC step on its own view and log equals the
    reference's single-server ``gc.gc_round`` over the whole pool, and
    every server's log equals the reference's one."""
    _, lay, st, _ = aged
    R = lay.catalog.total_records
    tbl, vec = _placed(st, S, part)
    logs = store.init_shard_logs(S, 3, T, device="cpu")
    gc_fn = store.distributed_gc_round(S, shard_vector=part, n_vec_slots=T)
    jtbl, jlog = _jtable(st.nam.table), jgc.init_log(3, T)
    live = st.nam.oracle_state.vec
    was = int(jnp.sum(jmvcc.hdr_ops.is_deleted(jtbl.ovf_hdr)))
    for now, v in ((2, live // 4), (4, live // 2), (6, live)):
        pv = store.shard_vector(S, v) if part else v
        assert gc_fn(tbl, pv, logs, now, 1)[0] is tbl
        jtbl, jlog = jgc.gc_round(jtbl, _ju32(v), jlog, now, 1)
    for f in tbl._fields:
        _eq(getattr(jtbl, f), getattr(tbl, f)[:R], f)
    for s in range(S):
        _eq(jlog.times, logs.times[s], f"times[{s}]")
        _eq(jlog.vecs, logs.vecs[s], f"vecs[{s}]")
    assert int(jnp.sum(jmvcc.hdr_ops.is_deleted(jtbl.ovf_hdr))) > was
    assert float(gc.reclaimable_fraction(tbl, n_records=R)) == float(
        jgc.reclaimable_fraction(jtbl, n_records=R))


@pytest.mark.parametrize("S", [2, 3])
def test_convert_carries_shard_logs_and_replica_journals(aged, S):
    """The reference's per-server snapshot logs (a leading shard axis) and
    a journal of a replica a server cross ``convert`` as they are, after
    a GC step and an append."""
    _, _, st, _ = aged
    vec = st.nam.oracle_state.vec
    jlog = jstore.init_shard_logs(S, 3, T)
    jlog = jgc.SnapshotLog(*(jnp.asarray(x) for x in jax_log_step(jlog,
                                                                  vec)))
    plog = convert.snapshot_log_from_numpy(jlog, "cpu")
    _eq(jlog.times, plog.times, "times")
    _eq(jlog.vecs, plog.vecs, "vecs")
    for a, b in zip(jlog, convert.snapshot_log_to_numpy(plog)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    jj = jwal.init_journal(T, 2, T, 3, 8, n_replicas=S)
    jj = jwal.append_intent(
        jj, jnp.arange(T, dtype=jnp.int32), _ju32(vec),
        jnp.full((T, 3), 5, jnp.int32), jnp.ones((T, 3, 2), jnp.uint32),
        jnp.ones((T, 3, 8), jnp.int32), jnp.ones((T, 3), bool), round_no=1,
        seq=2)
    pj = convert.journal_from_numpy(jax.tree.map(np.asarray, jj), "cpu")
    assert pj.n_replicas == S
    for f, a, b in zip(pj._fields, jj, convert.journal_to_numpy(pj)):
        assert np.asarray(a).dtype == b.dtype, f
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)


def jax_log_step(jlog, vec):
    """Every server's log after one snapshot of ``vec`` at time 3."""
    times, vecs = np.asarray(jlog.times).copy(), np.asarray(jlog.vecs).copy()
    for s in range(times.shape[0]):
        log = jgc.take_snapshot(jgc.SnapshotLog(jnp.asarray(times[s]),
                                                jnp.asarray(vecs[s])), 3,
                                _ju32(vec))
        times[s], vecs[s] = np.asarray(log.times), np.asarray(log.vecs)
    return times, vecs


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", DECIDE_CASES_ALL)
def test_decide_apply_over_servers_matches_the_plain_rendering(name, S):
    """The adversarial commit cases over ``S`` servers: the decide-only
    twin, the sum and the apply a server equal the reference's plain
    rendering over the servers (arbitrate, the summed failures, install,
    release, make-visible), state and decision."""
    case = dict(decide_cases())[name]
    _assert_leaves_equal(mesh_commit(case, S, False),
                         mesh_commit(case, S, True), MESH_OUT)
