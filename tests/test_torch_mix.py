"""The port's full five-transaction TPC-C mix against ``repro.db.tpcc``.

Both packages start from the reference's state, carried across with
``repro_torch.convert``, and run the same inputs: the reference's
``jax.random`` draws, converted through numpy. The single-round functions
are held against the reference on a state a few new-order rounds old, and
from such a state the mixed driver over 6 rounds in three cases (slot-addressed, key-addressed
with both kernel flags, warehouse-major with a locality measurement and a
skewed draw). Every output is an integer or a bool and is compared exactly,
as are the run statistics and the cost-model profiles derived from them.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import locality as jlocality
from repro.core.tsoracle import VectorOracle as JOracle
from repro.db import tpcc as jtpcc, workload as jworkload

from repro_torch import convert
from repro_torch._u32 import np_to_i32
from repro_torch.core import locality
from repro_torch.core.tsoracle import VectorOracle
from repro_torch.db import tpcc, workload

from test_torch_tpcc import _eq, _eq_state

FLAGS = dict(key_addressed=True, fused_commit=True, batched_probe=True)
SMALL = dict(n_warehouses=2, customers_per_district=8, n_items=64,
             n_threads=16, orders_per_thread=16, dist_degree=50.0)
# more deliveries and read-only lanes than the standard mix, so that six
# rounds reach every outcome of the rarer types
TEST_MIX = {"neworder": 0.3, "payment": 0.2, "orderstatus": 0.2,
            "delivery": 0.15, "stocklevel": 0.15}
N_ROUNDS = 6
WRITE_TYPES = {"neworder": ("committed", "snapshot_miss", "o_id"),
               "payment": ("committed", "snapshot_miss"),
               "delivery": ("committed", "delivered", "snapshot_miss")}
READ_TYPES = ("orderstatus", "stocklevel")


def _conv(x):
    """A reference NamedTuple of arrays (nested) as the port's tensors."""
    if hasattr(x, "_fields"):
        return type(x)(*(_conv(y) for y in x))
    return torch.from_numpy(np_to_i32(np.array(x)))


def _aged_start(kw, n_rounds=3):
    """The reference's loaded state after ``n_rounds`` new-order rounds,
    so that districts hold orders to deliver and to report on."""
    jcfg, cfg = jtpcc.TPCCConfig(**kw), tpcc.TPCCConfig(**kw)
    lay, jst = jtpcc.init_tpcc(jcfg, JOracle(jcfg.n_threads),
                               jax.random.PRNGKey(0))
    jst, _ = jtpcc.run_neworder_rounds(jcfg, lay, jst,
                                       JOracle(jcfg.n_threads),
                                       jax.random.PRNGKey(5), n_rounds)
    return jcfg, cfg, lay, jst


def _port_state(jst):
    return convert.tpcc_state_from_numpy(jax.tree.map(np.asarray, jst),
                                         "cpu")


def _eq_tuple(ref, port, what):
    for f in port._fields:
        _eq(getattr(ref, f), getattr(port, f), f"{what}.{f}")


def _eq_write(jo, po, fields, what):
    for f in fields:
        _eq(getattr(jo, f), getattr(po, f), f"{what} {f}")
    _eq_tuple(jo.ops, po.ops, f"{what} ops")
    _eq_tuple(jo.vis, po.vis, f"{what} vis")
    _eq_tuple(jo.batch, po.batch, f"{what} batch")


def _eq_readonly(jo, po, what):
    for f in ("result", "found", "read_slots", "read_mask"):
        _eq(getattr(jo, f), getattr(po, f), f"{what} {f}")
    _eq_tuple(jo.ops, po.ops, f"{what} ops")


# ------------------------------------------------- single-round functions --
@pytest.fixture(scope="module")
def aged():
    """A key-addressed state three new-order rounds old (numpy leaves),
    and the districts that hold undelivered orders."""
    jcfg, cfg, lay, jst = _aged_start(dict(SMALL, **FLAGS))
    st = jax.tree.map(np.asarray, jst)
    d = lay.catalog["district"]
    ddata = st.nam.table.cur_data[d.base:d.end]
    busy = np.nonzero(ddata[:, tpcc.D_COL["next_o_id"]]
                      > ddata[:, tpcc.D_COL["next_deliv"]])[0]
    assert len(busy) >= 4
    return jcfg, cfg, lay, st, busy


def _district_inputs(busy, T, rng):
    """(w, d) per thread: mostly districts with undelivered orders, every
    fourth thread a district drawn at random (most of them empty)."""
    pick = busy[np.arange(T) % len(busy)]
    pick[::4] = rng.randint(0, 2 * tpcc.DISTRICTS, len(pick[::4]))
    return ((pick // tpcc.DISTRICTS).astype(np.int32),
            (pick % tpcc.DISTRICTS).astype(np.int32))


def _round_pair(aged, seed):
    jcfg, cfg, lay, st, busy = aged
    rng = np.random.RandomState(seed)
    T = jcfg.n_threads
    active = rng.rand(T) < 0.7
    active[:2] = True
    w, d = _district_inputs(busy, T, rng)
    return (jcfg, cfg, lay, jax.tree.map(jnp.asarray, st),
            convert.tpcc_state_from_numpy(st, "cpu"), rng, active, w, d)


@pytest.mark.parametrize("seed", [0, 1])
def test_payment_round_matches_reference(aged, seed):
    jcfg, cfg, lay, jst, pst, rng, active, _, _ = _round_pair(aged, seed)
    T = jcfg.n_threads
    jinp = jworkload.gen_payment(jax.random.PRNGKey(10 + seed), T,
                                 jcfg.n_warehouses,
                                 jcfg.customers_per_district)
    jo = jtpcc.payment_round(jcfg, lay, jst, JOracle(T), jinp,
                             active=jnp.asarray(active))
    po = tpcc.payment_round(cfg, lay, pst, VectorOracle(T), _conv(jinp),
                            active=torch.from_numpy(active))
    _eq_write(jo, po, WRITE_TYPES["payment"], "payment")
    _eq_state(jo.state, po.state)
    c = po.committed.numpy()
    assert c.any() and (active & ~c).any()   # commits and contention aborts


@pytest.mark.parametrize("seed", [0, 1])
def test_delivery_round_matches_reference(aged, seed):
    jcfg, cfg, lay, jst, pst, rng, active, w, d = _round_pair(aged, seed)
    T = jcfg.n_threads
    carrier = rng.randint(1, 11, T).astype(np.int32)
    jinp = jworkload.DeliveryInputs(jnp.asarray(w), jnp.asarray(d),
                                    jnp.asarray(carrier))
    jo = jtpcc.delivery_round(jcfg, lay, jst, JOracle(T), jinp,
                              active=jnp.asarray(active))
    po = tpcc.delivery_round(cfg, lay, pst, VectorOracle(T), _conv(jinp),
                             active=torch.from_numpy(active))
    _eq_write(jo, po, WRITE_TYPES["delivery"], "delivery")
    _eq_state(jo.state, po.state)
    dl = po.delivered.numpy()
    assert dl.any() and (active & ~dl).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_orderstatus_round_matches_reference(aged, seed):
    jcfg, cfg, lay, jst, pst, rng, active, w, d = _round_pair(aged, seed)
    T = jcfg.n_threads
    c = rng.randint(0, jcfg.customers_per_district, T).astype(np.int32)
    jinp = jworkload.OrderStatusInputs(*map(jnp.asarray, (w, d, c)))
    jo = jtpcc.orderstatus_round(jcfg, lay, jst, JOracle(T), jinp,
                                 active=jnp.asarray(active))
    po = tpcc.orderstatus_round(cfg, lay, pst, VectorOracle(T), _conv(jinp),
                                active=torch.from_numpy(active))
    _eq_readonly(jo, po, "orderstatus")
    found = po.found.numpy()
    assert found.any() and (active & ~found).any()
    # the single-call form: customer, latest order, found
    args = [torch.from_numpy(x) for x in (w, d, c)]
    jres = jtpcc.orderstatus(jcfg, lay, jst, JOracle(T),
                             *map(jnp.asarray, (w, d, c)))
    pres = tpcc.orderstatus(cfg, lay, pst, VectorOracle(T), *args)
    for r, (jr, pr) in enumerate(zip(jres[:2], pres[:2])):
        _eq_tuple(jr, pr, f"orderstatus read {r}")
    _eq(jres[2], pres[2], "orderstatus found")


@pytest.mark.parametrize("seed", [0, 1])
def test_stocklevel_round_matches_reference(aged, seed):
    """With a threshold above the starting quantities of some stocks the
    count is non-zero on some lanes."""
    jcfg, cfg, lay, jst, pst, rng, active, w, d = _round_pair(aged, seed)
    T = jcfg.n_threads
    thr = rng.choice([15, 60, 101], T).astype(np.int32)
    jinp = jworkload.StockLevelInputs(*map(jnp.asarray, (w, d, thr)))
    for last_n in (8, 2):
        jo = jtpcc.stocklevel_round(jcfg, lay, jst, JOracle(T), jinp,
                                    active=jnp.asarray(active),
                                    last_n=last_n)
        po = tpcc.stocklevel_round(cfg, lay, pst, VectorOracle(T),
                                   _conv(jinp),
                                   active=torch.from_numpy(active),
                                   last_n=last_n)
        _eq_readonly(jo, po, f"stocklevel last_n={last_n}")
        assert (po.result.numpy() > 0).any()
    for t in range(3):     # the single-call form over one district
        args = (int(w[t]), int(d[t]), int(thr[t]))
        ref = jtpcc.stocklevel(jcfg, lay, jst, JOracle(T), jnp.int32(args[0]),
                               jnp.int32(args[1]), args[2], last_n=4)
        port = tpcc.stocklevel(cfg, lay, pst, VectorOracle(T),
                               torch.tensor(args[0], dtype=torch.int32),
                               torch.tensor(args[1], dtype=torch.int32),
                               args[2], last_n=4)
        assert int(ref) == int(port)


# ------------------------------------------------------------ the driver ----
MIX_CASES = {
    "slot_addressed": (dict(SMALL), False),
    "key_addressed_kernels": (dict(SMALL, **FLAGS), False),
    "warehouse_major_locality_skew": (
        dict(SMALL, n_items=32, n_threads=8, orders_per_thread=8,
             layout="warehouse_major", **FLAGS), True),
}
ROUND_FNS = ("neworder_round", "payment_round", "delivery_round",
             "orderstatus_round", "stocklevel_round")


def _recording(mod, name, log):
    fn = getattr(mod, name)

    def rec(*a, **k):
        out = fn(*a, **k)
        log.append((name, out))
        return out
    return rec


def _mixed_draws(jcfg, seed, n_rounds, home_w, skew):
    """The reference driver's per-round ``gen_mixed`` draws, converted."""
    logits = jworkload.zipf_logits(jcfg.n_items, jcfg.skew_alpha)
    key = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        draws.append(_conv(jworkload.gen_mixed(
            sub, jcfg.n_threads, jcfg.n_warehouses, jcfg.n_items,
            jcfg.customers_per_district, home_w, jcfg.dist_degree, logits,
            TEST_MIX, skew=skew)))
    return draws


def _same(a, b):
    """Equal, or both NaN (the local fraction of a run that measures no
    locality)."""
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


@pytest.mark.parametrize("name", sorted(MIX_CASES))
def test_mixed_rounds_match_reference(name, monkeypatch):
    kw, pinned = MIX_CASES[name]
    jcfg, cfg, lay, jst = _aged_start(kw)
    pst = _port_state(jst)
    T, W = jcfg.n_threads, jcfg.n_warehouses
    jkw, pkw, home_w, skew = {}, {}, None, None
    if pinned:
        home_w = jlocality.thread_homes(T, W)
        skew = jworkload.make_skew(W, wh_alpha=1.0, hot_district_mass=0.6,
                                   remote_frac=0.5)
        jkw = dict(home_w=home_w, locality_mode="aware", skew=skew)
        pkw = dict(home_w=locality.thread_homes(T, W), locality_mode="aware")

    jlog, plog = [], []
    for fn in ROUND_FNS:
        monkeypatch.setattr(jtpcc, fn, _recording(jtpcc, fn, jlog))
        monkeypatch.setattr(tpcc, fn, _recording(tpcc, fn, plog))
    jst, js = jtpcc.run_mixed_rounds(jcfg, lay, jst, JOracle(T),
                                     jax.random.PRNGKey(1), N_ROUNDS,
                                     mix=TEST_MIX, **jkw)
    draws = _mixed_draws(jcfg, 1, N_ROUNDS, home_w, skew)
    pst, ps = tpcc.run_mixed_rounds(cfg, tpcc.make_layout(cfg), pst,
                                    VectorOracle(T), lambda r: draws[r],
                                    N_ROUNDS, device="cpu", **pkw)

    assert [n for n, _ in jlog] == [n for n, _ in plog]
    for i, ((n, jo), (_, po)) in enumerate(zip(jlog, plog)):
        kind = n[:-len("_round")]
        if kind in READ_TYPES:
            _eq_readonly(jo, po, f"call {i} {n}")
        else:
            _eq_write(jo, po, WRITE_TYPES[kind], f"call {i} {n}")
    _eq_state(jst, pst)
    for f in ps._fields:
        assert _same(getattr(js, f), getattr(ps, f)), f
    assert not set(js._fields) - set(ps._fields) - {"growth"}, \
        "a statistic of the reference is missing"

    jprof, jmix = jtpcc.mixed_profiles(js)
    pprof, pmix = tpcc.mixed_profiles(ps)
    assert dataclasses.astuple(jmix) == dataclasses.astuple(pmix)
    for n in workload.TXN_TYPES:
        assert dataclasses.astuple(jprof[n]) == dataclasses.astuple(pprof[n])
    assert jtpcc.neworder_share(js) == tpcc.neworder_share(ps)

    # every type ran, some deliveries delivered, some order-status lanes
    # found an order, and write types both committed and aborted
    assert all(ps.attempts[n] > 0 for n in workload.TXN_TYPES)
    assert ps.delivered > 0
    assert any(bool(po.found.any()) for n, po in plog
               if n == "orderstatus_round")
    assert 0 < ps.total_commits < ps.total_attempts
    if pinned:
        assert ps.local_fraction == 1.0      # one memory server
    else:
        assert math.isnan(ps.local_fraction)


def test_mixed_rounds_reject_wrong_homes_under_locality():
    kw = dict(SMALL, n_items=32, n_threads=8, layout="warehouse_major")
    cfg = tpcc.TPCCConfig(**kw)
    lay, st = tpcc.init_tpcc(cfg, VectorOracle(cfg.n_threads), device="cpu")
    with pytest.raises(ValueError, match="thread_homes"):
        tpcc.run_mixed_rounds(cfg, lay, st, VectorOracle(cfg.n_threads),
                              lambda r: None, 1, locality_mode="aware",
                              device="cpu")


# ------------------------------------------------------- the port's draws --
def test_mix_and_skew_logits_match_reference():
    """float32 logits: equal to the reference within one float32 rounding
    of ``log`` (the two libraries' ``log`` may differ in the last bit)."""
    for mix in (None, TEST_MIX, {"neworder": 1.0}):
        np.testing.assert_allclose(workload.mix_logits(mix).numpy(),
                                   np.asarray(jworkload.mix_logits(mix)),
                                   rtol=2e-7)
    js = jworkload.make_skew(5, wh_alpha=0.9, hot_district_mass=0.7,
                             remote_frac=0.3)
    ps = workload.make_skew(5, wh_alpha=0.9, hot_district_mass=0.7,
                            remote_frac=0.3)
    for a, b in ((js.wh_logits, ps.wh_logits), (js.d_logits, ps.d_logits)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-7)
    assert js.remote_frac == ps.remote_frac
    assert workload.make_skew(5) == (None, None, 0.15)


def test_mixed_stream_draws_reference_ranges():
    """The port's own stream: types from the mix, pinned homes, the hot
    district, remote payment customers only on other warehouses."""
    cfg = tpcc.TPCCConfig(**dict(SMALL, n_warehouses=4))
    T, W = cfg.n_threads, cfg.n_warehouses
    homes = locality.thread_homes(T, W)
    skew = workload.make_skew(W, hot_district_mass=0.9, remote_frac=1.0)
    draw = workload.mixed_stream(cfg, torch.Generator().manual_seed(0),
                                 mix={"payment": 0.5, "delivery": 0.5},
                                 skew=skew, home_w=homes, dist_degree=100.0)
    seen = set()
    for r in range(4):
        inp = draw(r)
        seen |= set(inp.txn_type.tolist())
        for sub in inp[1:]:
            assert torch.equal(sub.w_id, homes)
            assert ((sub.d_id >= 0) & (sub.d_id < tpcc.DISTRICTS)).all()
        assert (inp.payment.c_w_id != inp.payment.w_id).all()
        assert ((inp.payment.amount >= 100)
                & (inp.payment.amount < 500000)).all()
        assert ((inp.delivery.carrier >= 1)
                & (inp.delivery.carrier <= 10)).all()
        assert ((inp.stocklevel.threshold >= 10)
                & (inp.stocklevel.threshold <= 20)).all()
        assert inp.neworder.is_remote[:, 0].all()
    assert seen == {1, 3}
    hot = torch.cat([draw(r).payment.d_id for r in range(8)])
    assert (hot == 0).float().mean() > 0.7
