"""The port's protocol core (``repro_torch.core``) against ``repro.core``.

Inputs are drawn with numpy from a seed and fed to both packages; every
output is an integer or a bool, compared exactly (uint32 lanes viewed as
the port's int32 words).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cas as jcas, catalog as jcatalog, hashtable as jht, \
    header as jhdr, mvcc as jmvcc, rangeindex as jri, store as jstore
from repro.core.tsoracle import VectorOracle as JOracle

from repro_torch._u32 import np_to_i32
from repro_torch.core import cas, catalog, hashtable as ht, header as hdr, \
    mvcc, rangeindex as ri, store
from repro_torch.core.tsoracle import VectorOracle

from test_torch_gpu import _hdr, _probe_table, port_table


def _t(a):
    return torch.from_numpy(np_to_i32(a))


def _eq(ref, port, what=""):
    a = np_to_i32(np.asarray(ref))
    b = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_tuple(ref, port):
    for f in port._fields:
        _eq(getattr(ref, f), getattr(port, f), f)


def _jtable(tbl):
    return jmvcc.VersionedTable(**{k: jnp.asarray(v) for k, v in tbl.items()})


def _words(rng, shape):
    """uint32 words across the whole range, with the ends included."""
    w = rng.randint(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return w


# ---------------------------------------------------------------- header ----
@pytest.mark.parametrize("seed", [0, 1])
def test_header_matches_reference(seed):
    rng = np.random.RandomState(seed)
    n = 64
    tid = rng.randint(0, 1 << 29, n).astype(np.uint32)
    cts = _words(rng, n)
    flags = [rng.rand(n) < 0.5 for _ in range(3)]
    jh = jhdr.pack(tid, cts, moved=flags[0], deleted=flags[1],
                   locked=flags[2])
    th = hdr.pack(_t(tid), _t(cts), moved=torch.from_numpy(flags[0]),
                  deleted=torch.from_numpy(flags[1]),
                  locked=torch.from_numpy(flags[2]))
    _eq(jh, th, "pack")
    _eq(np.asarray(jhdr.thread_id(jh)).astype(np.int64), hdr.thread_id(th),
        "thread_id")
    _eq(jhdr.commit_ts(jh), hdr.commit_ts(th), "commit_ts")
    for name in ("is_locked", "is_deleted", "is_moved"):
        _eq(getattr(jhdr, name)(jh), getattr(hdr, name)(th), name)
    on = rng.rand(n) < 0.5
    for name in ("with_lock", "with_moved", "with_deleted"):
        _eq(getattr(jhdr, name)(jh, on),
            getattr(hdr, name)(th, torch.from_numpy(on)), name)
        _eq(getattr(jhdr, name)(jh, False), getattr(hdr, name)(th, False),
            name)
    other = jh.at[::3, 1].add(1)
    _eq(jhdr.equal(jh, other), hdr.equal(th, _t(np.asarray(other))), "equal")
    # visibility: thread ids past the vector clamp to its last slot, and
    # stamps near 2**32 compare unsigned
    small = _hdr(rng.randint(0, 9, n), _words(rng, n), 0)
    ts = _words(rng, 5)
    _eq(jhdr.visible(jnp.asarray(small), jnp.asarray(ts)),
        hdr.visible(_t(small), _t(ts)), "visible")


# ------------------------------------------------------------------- cas ----
def _cas_case(seed, R=32, Q=48):
    rng = np.random.RandomState(seed)
    r = np.arange(R)
    hdrs = _hdr(r % 5, _words(rng, R), np.where(r % 7 == 0, 1, 0))
    slots = rng.randint(0, R // 4, Q).astype(np.int32)   # hot duplicates
    slots[::3] = rng.randint(0, R, Q)[::3]
    expected = hdrs[slots].copy()
    expected[rng.rand(Q) < 0.2, 1] ^= 1                  # stale
    prio = rng.permutation(Q).astype(np.uint32)
    prio[:2] = [0xFFFFFFFF, 0x80000000]
    active = rng.rand(Q) < 0.85
    return hdrs, slots, expected, prio, active


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cas_arbitrate_and_release_match_reference(seed):
    hdrs, slots, expected, prio, active = _cas_case(seed)
    jres = jcas.arbitrate(jnp.asarray(hdrs), jnp.asarray(slots),
                          jnp.asarray(expected), jnp.asarray(prio),
                          jnp.asarray(active))
    th = _t(hdrs)
    tres = cas.arbitrate(th, _t(slots), _t(expected), _t(prio),
                         torch.from_numpy(active))
    _eq(jres.granted, tres.granted, "granted")
    _eq(jres.new_hdr, tres.new_hdr, "new_hdr")
    assert tres.new_hdr is th                        # updated in place
    g = np.asarray(jres.granted)
    assert g.any() and (active & ~g).any()
    mask = g & (np.arange(len(g)) % 2 == 0)
    _eq(jcas.release(jres.new_hdr, jnp.asarray(slots), jnp.asarray(mask)),
        cas.release(tres.new_hdr, _t(slots), torch.from_numpy(mask)),
        "release")


# ------------------------------------------------------------------ mvcc ----
def test_init_table_matches_reference():
    _eq_tuple(jmvcc.init_table(10, 3, n_old=2, n_overflow=4),
              mvcc.init_table(10, 3, n_old=2, n_overflow=4, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mvcc_readers_match_reference(seed):
    tbl, ts = _probe_table(seed)
    rng = np.random.RandomState(seed)
    slots = rng.randint(0, 48, 96).astype(np.int32)
    slots[:4] = np.arange(4)
    slots[4:6] = [-2, 60]                    # JAX gather semantics
    jt, tt = _jtable(tbl), port_table(tbl)
    jloc = jmvcc.locate_visible(jt, jnp.asarray(slots), jnp.asarray(ts))
    tloc = mvcc.locate_visible(tt, _t(slots), _t(ts))
    _eq_tuple(jloc, tloc)
    assert set(np.asarray(jloc.src)[np.asarray(jloc.found)]) == {0, 1, 2}
    for a, b in zip(jmvcc.gather_version(jt, jnp.asarray(slots), jloc),
                    mvcc.gather_version(tt, _t(slots), tloc)):
        _eq(a, b, "gather_version")
    _eq_tuple(jmvcc.read_visible(jt, jnp.asarray(slots), jnp.asarray(ts)),
              mvcc.read_visible(tt, _t(slots), _t(ts)))
    for a, b in zip(jmvcc.read_current(jt, jnp.asarray(slots)),
                    mvcc.read_current(tt, _t(slots))):
        _eq(a, b, "read_current")


@pytest.mark.parametrize("seed", [0, 1])
def test_mvcc_install_matches_reference(seed):
    """Installs at ring positions past several revolutions, with some ring
    victims not yet moved (install refused) and masked-out lanes."""
    tbl, _ = _probe_table(seed)
    rng = np.random.RandomState(seed)
    slots = rng.permutation(48)[:20].astype(np.int32)
    new_hdr = _hdr(rng.randint(0, 4, 20), _words(rng, 20), 1)  # locked
    new_data = rng.randint(0, 1000, (20, 4)).astype(np.int32)
    mask = rng.rand(20) < 0.8
    jout = jmvcc.install(_jtable(tbl), jnp.asarray(slots), jnp.asarray(new_hdr),
                         jnp.asarray(new_data), jnp.asarray(mask))
    tt = port_table(tbl)
    tout = mvcc.install(tt, _t(slots), _t(new_hdr), _t(new_data),
                        torch.from_numpy(mask))
    _eq(jout.installed, tout.installed, "installed")
    _eq_tuple(jout.table, tout.table)
    inst = np.asarray(jout.installed)
    assert inst.any() and (mask & ~inst).any()
    assert (tbl["next_write"][slots[inst]] >= 2).any()     # wraparound


@pytest.mark.parametrize("reuse_only", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_version_mover_matches_reference(seed, reuse_only):
    tbl, _ = _probe_table(seed)
    jt = jmvcc.version_mover(_jtable(tbl), 2, reuse_only=reuse_only)
    tt = mvcc.version_mover(port_table(tbl), 2, reuse_only=reuse_only)
    _eq_tuple(jt, tt)
    moved = np.asarray(jt.ovf_next) != tbl["ovf_next"]
    assert moved.any() and (~moved).any()


def test_oracle_make_visible_matches_reference():
    rng = np.random.RandomState(3)
    T = 6
    vec = _words(rng, T)
    tid = np.arange(T, dtype=np.int32)[::-1].copy()
    cts = _words(rng, T)
    committed = rng.rand(T) < 0.6
    js = JOracle(T).make_visible(
        JOracle(T).init()._replace(vec=jnp.asarray(vec)), jnp.asarray(tid),
        jnp.asarray(cts), jnp.asarray(committed))
    o = VectorOracle(T)
    ts = o.init(device="cpu")._replace(vec=_t(vec))
    _eq(js.vec, o.make_visible(ts, _t(tid), _t(cts),
                               torch.from_numpy(committed)).vec, "vec")
    _eq(JOracle(T).next_commit_ts(js, jnp.asarray(tid)),
        o.next_commit_ts(ts, _t(tid)), "next_commit_ts")


# ------------------------------------------------------------- hashtable ----
@pytest.mark.parametrize("n_buckets,max_probes", [(64, 16), (256, 32),
                                                  (32, 4)])
def test_hashtable_matches_reference(n_buckets, max_probes):
    """Keys near 2**32 (the hash multiply overflows int64 unless split),
    duplicate keys within one batch, masked lanes and, at 32 buckets with
    4 probes, exhausted probe chains (``placed_at == -1``)."""
    rng = np.random.RandomState(n_buckets)
    keys = _words(rng, 28)
    keys[4:8] = [0xFFFFFFFE, 0xFFFFFFF0, 0x80000001, 0xC0000000]
    keys[8] = keys[9]
    vals = rng.randint(0, 1000, 28).astype(np.int32)
    mask = rng.rand(28) < 0.9
    jt, jplaced = jht.insert(jht.init(n_buckets), jnp.asarray(keys),
                             jnp.asarray(vals), jnp.asarray(mask),
                             max_probes=max_probes)
    tt, tplaced = ht.insert(ht.init(n_buckets, device="cpu"), _t(keys),
                            _t(vals), torch.from_numpy(mask),
                            max_probes=max_probes)
    _eq(jplaced, tplaced, "placed_at")
    _eq_tuple(jt, tt)
    if n_buckets == 32:
        assert (np.asarray(jplaced)[mask] < 0).any()
    jt, _ = jht.delete(jt, jnp.asarray(keys[10:12]), max_probes=max_probes)
    tt = tt._replace(vals=_t(np.asarray(jt.vals)))
    queries = np.concatenate([keys, _words(rng, 8),
                              np.array([0xFFFFFFFF], np.uint32)])
    for a, b in zip(jht.lookup(jt, jnp.asarray(queries), max_probes),
                    ht.lookup(tt, _t(queries), max_probes)):
        _eq(a, b, "lookup")
    _eq(jht._hash(jnp.asarray(queries), n_buckets),
        ht._hash(_t(queries), n_buckets), "hash")


# ------------------------------------------------------------ rangeindex ----
def test_rangeindex_matches_reference():
    """SENTINEL (0xFFFFFFFF, -1 as int32) and keys past 2**31 sort by their
    unsigned value, and the delta buffer saturates at its capacity."""
    rng = np.random.RandomState(5)
    keys = _words(rng, 12)
    vals = rng.randint(0, 100, 12).astype(np.int32)
    jidx = jri.build(jnp.asarray(keys), jnp.asarray(vals), capacity=16,
                     delta_capacity=8)
    tidx = ri.build(_t(keys), _t(vals), capacity=16, delta_capacity=8)
    _eq_tuple(jidx, tidx)
    assert np.asarray(jidx.base_keys)[11] == 0xFFFFFFFF
    for step in range(3):
        k = _words(rng, 5)
        v = rng.randint(0, 100, 5).astype(np.int32)
        m = rng.rand(5) < 0.8
        jidx = jri.insert(jidx, jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(m))
        tidx = ri.insert(tidx, _t(k), _t(v), torch.from_numpy(m))
        _eq_tuple(jidx, tidx)
    assert int(jidx.delta_used) == 8


# ----------------------------------------------------------------- store ----
def test_store_loaders_match_reference():
    jcat, tcat = jcatalog.Catalog(), catalog.Catalog()
    for c in (jcat, tcat):
        c.create_table("a", 7, 4)
        c.create_table("b", 5, 3)
    assert [dataclass_tuple(s) for s in jcat.specs.values()] == \
        [dataclass_tuple(s) for s in tcat.specs.values()]
    js = jstore.init_store(jcat, JOracle(3), n_old=2, n_overflow=2,
                           n_insert_regions=2)
    ts = store.init_store(tcat, VectorOracle(3), n_old=2, n_overflow=2,
                          n_insert_regions=2, device="cpu")
    js = jstore.mark_region_deleted(js, 7, 5)
    ts = store.mark_region_deleted(ts, 7, 5)
    js = jstore.mark_slots_deleted(js, jnp.asarray([0, 3, 3]))
    ts = store.mark_slots_deleted(ts, torch.tensor([0, 3, 3]))
    _eq_tuple(js.table, ts.table)
    _eq(js.oracle_state.vec, ts.oracle_state.vec, "vec")
    _eq(js.extends.cursor, ts.extends.cursor, "cursor")


def dataclass_tuple(spec):
    return (spec.name, spec.base, spec.count, spec.width, spec.n_columns,
            spec.kind)


def test_build_directory_matches_reference_and_raises_on_exhaustion():
    keys = (np.arange(40, dtype=np.uint64) * 977 + 3).astype(np.uint32)
    slots = np.arange(40, dtype=np.int32)
    _eq_tuple(jstore.build_directory(jnp.asarray(keys), jnp.asarray(slots),
                                     128, max_probes=32),
              store.build_directory(_t(keys), _t(slots), 128, max_probes=32))
    with pytest.raises(ValueError, match="dropped"):
        store.build_directory(_t(keys), _t(slots), 32, max_probes=2)
