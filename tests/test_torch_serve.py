"""The port's serve path against the reference's, on the CPU.

The paged KV pool's functions (``serve/kvcache.py``) are held bit for bit
against the reference's on constructed tables: allocation past the free
pages, mapping past the table's edge, shared prefixes released, writes
to unmapped pages dropped. ``make_prompts`` is held against the
reference's with the seed the reference draws from its key. The engine
runs ``examples/serve_lm.py``'s traffic (12 requests, 8 slots, two waves,
stragglers forced done and released) on reduced mixtral-8x22b and
gemma2-27b in float32 beside the reference's engine: the integer state
(page headers, refcounts, page table, lengths, flags, epoch) and the
tokens are equal after every admission, step and release, and the pools
within the kernels' bfloat16 rule. Two facts of
the reference are pinned: its decode order (each unit position's layers
of every unit, then the next position) and a prompt longer than
``MAX_PAGES_PER_ALLOC`` pages, of which only the first are mapped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget, reduced as jreduced
from repro.data.pipeline import make_prompts as jmake_prompts
from repro.models import transformer as jt
from repro.serve import engine as jengine, kvcache as jkvc

from repro_torch import convert
from repro_torch._u32 import np_to_i32
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import make_prompts
from repro_torch.kernels.tolerance import LM_TOL
from repro_torch.models import transformer
from repro_torch.serve import engine, kvcache as kvc

ECFG = dict(max_seqs=8, page_size=16, n_pages=128, max_len=128)
MAX_NEW = 4
BF16 = LM_TOL["bfloat16"]


def _i32(a):
    return np_to_i32(np.asarray(a))


def _t(a, dtype=None):
    return torch.from_numpy(np.array(_i32(a) if dtype is None else a,
                                     dtype))


def _same(ref, port, what=""):
    np.testing.assert_array_equal(port.cpu().numpy(), _i32(ref),
                                  err_msg=what)


def _meta_pair(P, used=(), shared=()):
    """A page meta with pages ``used`` allocated (refcount 1, epoch 3) and
    ``shared`` at refcount 2, in both packages."""
    meta = jkvc.init_meta(P)
    hdr = np.asarray(meta.hdr).copy()
    ref = np.zeros(P, np.int32)
    for p in used + shared:
        hdr[p] = [np.uint32(5 << 3), np.uint32(3)]
        ref[p] = 2 if p in shared else 1
    j = jkvc.PageMeta(hdr=jnp.asarray(hdr), refcount=jnp.asarray(ref))
    return j, kvc.PageMeta(hdr=_t(hdr), refcount=_t(ref))


def _table_pair(pt, kv_len, active):
    pt, kv_len = np.asarray(pt, np.int32), np.asarray(kv_len, np.int32)
    active = np.asarray(active, bool)
    j = jkvc.SeqTable(page_table=jnp.asarray(pt), kv_len=jnp.asarray(kv_len),
                      active=jnp.asarray(active))
    return j, kvc.SeqTable(page_table=_t(pt), kv_len=_t(kv_len),
                           active=_t(active))


def _same_meta(j, p):
    _same(j.hdr, p.hdr, "hdr")
    _same(j.refcount, p.refcount, "refcount")


def _same_table(j, p):
    _same(j.page_table, p.page_table, "page_table")
    _same(j.kv_len, p.kv_len, "kv_len")
    _same(j.active, p.active, "active")


# ------------------------------------------------------------ kvcache ----
def test_init_functions_match_reference():
    _same_meta(jkvc.init_meta(10), kvc.init_meta(10, "cpu"))
    _same_table(jkvc.init_seq_table(3, 5), kvc.init_seq_table(3, 5, "cpu"))
    jd, pd = jkvc.init_data(6, 4, 2, 8), kvc.init_data(6, 4, 2, 8,
                                                       device="cpu")
    assert pd.k.shape == (7,) + jd.k.shape[1:]     # and the sink page
    assert pd.k.dtype == torch.bfloat16 and not bool(pd.k.any())
    assert pd.page_size == jd.page_size


@pytest.mark.parametrize("want,used,epoch", [
    ([2, 0, 3], (), 1),
    ([4, 5, 1], (0, 3, 4), 7),          # the second overruns: ok False
    ([8, 1, 70], (2,), 0xFFFFFFFE),     # past MAX_PAGES_PER_ALLOC
    ([0, 0], tuple(range(12)), 2),      # nothing free, nothing wanted
], ids=["fits", "exhausted", "large", "empty"])
def test_alloc_pages_matches_reference(want, used, epoch):
    jm, pm = _meta_pair(12 if want[-1] < 64 else 96, used)
    want = np.asarray(want, np.int32)
    tid = np.arange(len(want), dtype=np.int32) + 2
    je = jnp.asarray(epoch, jnp.uint32)
    jm2, jpages, jok = jkvc.alloc_pages(jm, jnp.asarray(want),
                                        jnp.asarray(tid), je)
    pm2, ppages, pok = kvc.alloc_pages(pm, _t(want), _t(tid),
                                       _t(np.asarray(epoch, np.uint32)))
    _same_meta(jm2, pm2)
    _same(jpages, ppages, "pages")
    _same(jok, pok, "ok")
    if len(want) == 3 and want[1] == 5:
        assert not bool(pok.all())
    jf, pf = jkvc.fragmentation(jm2), kvc.fragmentation(pm2)
    assert float(pf) == float(jf)


def test_map_release_and_share_match_reference():
    jm, pm = _meta_pair(16)
    pt = np.full((4, 6), -1, np.int32)
    jt_, pt_ = _table_pair(pt, [0, 0, 0, 0], [False] * 4)
    want = np.array([3, 2, 4], np.int32)
    seq = np.array([0, 2, 3], np.int32)
    jm, jpages, _ = jkvc.alloc_pages(jm, jnp.asarray(want), jnp.asarray(seq),
                                     jnp.asarray(1, jnp.uint32))
    pm, ppages, _ = kvc.alloc_pages(pm, _t(want), _t(seq), _t(np.int32(1)))
    # the last sequence starts at column 4: two of its pages fall off
    start = np.array([0, 1, 4], np.int32)
    jt_ = jkvc.map_pages(jt_, jnp.asarray(seq), jpages, jnp.asarray(start))
    pt_ = kvc.map_pages(pt_, _t(seq), ppages, _t(start))
    _same_table(jt_, pt_)
    # slot 1 shares slot 0's first two pages; then 0 and 3 go
    jm, jt_ = jkvc.share_prefix(jm, jt_, 0, 1, 2)
    pm, pt_ = kvc.share_prefix(pm, pt_, 0, 1, 2)
    _same_meta(jm, pm)
    _same_table(jt_, pt_)
    rel = np.array([0, 3], np.int32)
    jm, jt_ = jkvc.release_seqs(jm, jt_, jnp.asarray(rel))
    pm, pt_ = kvc.release_seqs(pm, pt_, _t(rel))
    _same_meta(jm, pm)
    _same_table(jt_, pt_)
    # the shared pages survive until their last reader goes
    jm, jt_ = jkvc.release_seqs(jm, jt_, jnp.asarray([1], jnp.int32))
    pm, pt_ = kvc.release_seqs(pm, pt_, _t(np.array([1], np.int32)))
    _same_meta(jm, pm)
    _same_table(jt_, pt_)
    assert float(kvc.fragmentation(pm)) == float(jkvc.fragmentation(jm))


def _data_pair(P, ps, Hkv, Dh, seed):
    k = np.random.RandomState(seed).randn(P, ps, Hkv, Dh).astype(np.float32)
    v = np.random.RandomState(seed + 1).randn(P, ps, Hkv, Dh) \
        .astype(np.float32)
    j = jkvc.PageData(k=jnp.asarray(k, jnp.bfloat16),
                      v=jnp.asarray(v, jnp.bfloat16))
    p = kvc.init_data(P, ps, Hkv, Dh, device="cpu")
    p.k[:P] = convert.tensor_from_numpy(np.asarray(j.k))
    p.v[:P] = convert.tensor_from_numpy(np.asarray(j.v))
    return j, p


def _same_data(j, p):
    P = j.k.shape[0]
    np.testing.assert_array_equal(convert.tensor_to_numpy(p.k[:P]),
                                  np.asarray(j.k, np.float32))
    np.testing.assert_array_equal(convert.tensor_to_numpy(p.v[:P]),
                                  np.asarray(j.v, np.float32))


def test_writes_match_reference_and_drop_where_unmapped():
    P, ps, Hkv, Dh = 10, 4, 2, 8
    jd, pd = _data_pair(P, ps, Hkv, Dh, 0)
    # slot 0: pages 3, 7; slot 1: page 2 then unmapped; slot 2: nothing;
    # slot 3 at the table's last column (its next token clamps there)
    pt = np.array([[3, 7, -1], [2, -1, -1], [-1, -1, -1], [5, 6, 9]])
    jtab, ptab = _table_pair(pt, [5, 4, 0, 12], [True, True, False, True])
    rng = np.random.RandomState(2)
    kn, vn = rng.randn(4, Hkv, Dh), rng.randn(4, Hkv, Dh)
    seq = np.arange(4, dtype=np.int32)
    jd = jkvc.write_token(jd, jtab, jnp.asarray(seq),
                          jnp.asarray(kn, jnp.float32),
                          jnp.asarray(vn, jnp.float32))
    out = kvc.write_token(pd, ptab, _t(seq), torch.tensor(kn).float(),
                          torch.tensor(vn).float())
    assert out.k is pd.k                          # in place
    _same_data(jd, pd)
    ks, vs = rng.randn(3, 9, Hkv, Dh), rng.randn(3, 9, Hkv, Dh)
    lens = np.array([9, 6, 3], np.int32)
    seq = np.array([0, 1, 2], np.int32)
    jd = jkvc.write_prefill(jd, jtab, jnp.asarray(seq),
                            jnp.asarray(ks, jnp.float32),
                            jnp.asarray(vs, jnp.float32), jnp.asarray(lens))
    kvc.write_prefill(pd, ptab, _t(seq), torch.tensor(ks).float(),
                      torch.tensor(vs).float(), _t(lens))
    _same_data(jd, pd)
    jk, jv = jkvc.gather_kv(jd, jtab, jnp.asarray(seq), 12)
    pk, pv = kvc.gather_kv(pd, ptab, _t(seq), 12)
    np.testing.assert_array_equal(convert.tensor_to_numpy(pk),
                                  np.asarray(jk, np.float32))


def test_make_prompts_matches_reference_by_its_seed():
    key = jax.random.PRNGKey(7)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    for kw in (dict(min_len=4, max_len=20), dict(min_len=32, max_len=64)):
        ref = jmake_prompts(key, 12, 512, **kw)
        port = make_prompts(seed, 12, 512, **kw)
        assert len(ref) == len(port)
        for a, b in zip(ref, port):
            assert b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_kernel_lanes_pick_the_paged_contract():
    ps = 4
    # slot 0 active; 1 done at a page boundary (its next page unmapped);
    # 2 never admitted; 3 with a hole below the window only; 4 with a
    # hole inside it
    mapped = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0],
                       [0, 1, 1, 0], [1, 0, 1, 0]], bool)
    kv_len = np.array([9, 8, 0, 10, 10])
    np.testing.assert_array_equal(
        engine.kernel_lanes(kv_len, mapped, ps),
        [True, False, False, False, False])
    np.testing.assert_array_equal(
        engine.kernel_lanes(kv_len, mapped, ps, window=6),
        [True, False, False, True, False])


# ------------------------------------------------------------- engine ----
_RUNS = {}


def _state_np(st, jax_side):
    """The engine state's integer leaves and pools as numpy, the pools of
    the port per layer without the sink page, the reference's unstacked
    into execution order."""
    ints = [st.meta.hdr, st.meta.refcount, st.table.page_table,
            st.table.kv_len, st.table.active, st.tokens, st.done, st.epoch]
    if jax_side:
        ints = [_i32(a) for a in ints]
        pools = [np.asarray(d.k[u], np.float32) for u in range(
            st.data[0].k.shape[0]) for d in st.data]
        n_units = st.data[0].k.shape[0]
        ul = len(st.data)
        pools = [np.asarray(st.data[i % ul].k[i // ul], np.float32)
                 for i in range(n_units * ul)]
    else:
        ints = [a.numpy() for a in ints]
        pools = [convert.tensor_to_numpy(d.k[:-1]) for d in st.data]
    return ints, pools


def _traffic(eng, cfg_vocab, key, n=12):
    """serve_lm.py's loop; the state after every admission, step and
    release."""
    prompts = jmake_prompts(key, n, cfg_vocab, min_len=4, max_len=20)
    st = eng.init_state()
    out = []
    jax_side = isinstance(eng, jengine.Engine)
    pending = list(prompts)
    while pending:
        now, pending = pending[:8], pending[8:]
        st = eng.admit(st, now)
        out.append(("admit", _state_np(st, jax_side)))
        for _ in range(MAX_NEW - 1):
            if bool(np.asarray(st.done | ~st.table.active).all()):
                break
            st = eng.decode_step(st)
            out.append(("step", _state_np(st, jax_side)))
        st = st._replace(done=st.done | st.table.active)
        st = eng.release_finished(st)
        out.append(("release", _state_np(st, jax_side)))
    return out


def _engine_runs(aid):
    if aid not in _RUNS:
        jcfg = jreduced(jget(aid), dtype="float32")
        pcfg = reduced(get_arch(aid), dtype="float32")
        params = jt.init_params(jcfg, jax.random.PRNGKey(0))
        model = convert.lm_params_from_numpy(
            pcfg, jax.tree.map(np.asarray, params), "cpu")
        key = jax.random.PRNGKey(1)
        ref = _traffic(jengine.Engine(jcfg, params,
                                      jengine.EngineConfig(**ECFG)),
                       jcfg.vocab, key)
        port = _traffic(engine.Engine(pcfg, model,
                                      engine.EngineConfig(**ECFG),
                                      device="cpu"), pcfg.vocab, key)
        _RUNS[aid] = ref, port
    return _RUNS[aid]


@pytest.mark.parametrize("aid", ["mixtral-8x22b", "gemma2-27b"])
def test_engine_integer_state_and_tokens_match_reference(aid):
    ref, port = _engine_runs(aid)
    assert [k for k, _ in ref] == [k for k, _ in port]
    names = ("hdr", "refcount", "page_table", "kv_len", "active", "tokens",
             "done", "epoch")
    for n, ((kind, (ri, _)), (_, (pi, _))) in enumerate(zip(ref, port)):
        for name, a, b in zip(names, ri, pi):
            np.testing.assert_array_equal(b, a, err_msg=f"{kind} {n} {name}")
    assert sum(k == "step" for k, _ in ref) >= 2 * (MAX_NEW - 1) - 1


@pytest.mark.parametrize("aid", ["mixtral-8x22b", "gemma2-27b"])
def test_engine_pools_match_reference(aid):
    """The pools are bfloat16 in both engines, each K/V rounded from
    float32 values that agree to about 1e-5: held to the kernels'
    bfloat16 rule (``tolerance.LM_TOL``)."""
    ref, port = _engine_runs(aid)
    for (kind, (_, rp)), (_, (_, pp)) in zip(ref, port):
        for layer, (a, b) in enumerate(zip(rp, pp)):
            np.testing.assert_allclose(b, a, rtol=BF16, atol=BF16,
                                       err_msg=f"{kind} layer {layer}")


def test_engine_serve_matches_reference():
    jcfg = jreduced(jget("granite-3-8b"), dtype="float32")
    pcfg = reduced(get_arch("granite-3-8b"), dtype="float32")
    params = jt.init_params(jcfg, jax.random.PRNGKey(3))
    model = convert.lm_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params), "cpu")
    prompts = jmake_prompts(jax.random.PRNGKey(4), 5, jcfg.vocab)
    jo, js = jengine.Engine(jcfg, params, jengine.EngineConfig(**ECFG)) \
        .serve(prompts, max_new=3)
    eng = engine.Engine(pcfg, model, engine.EngineConfig(**ECFG),
                        kernels=True, device="cpu")
    po, ps = eng.serve(prompts, max_new=3)
    assert po == [[int(t) for t in o] for o in jo]
    _same(js.meta.hdr, ps.meta.hdr)
    _same(js.table.page_table, ps.table.page_table)


def test_engine_maps_only_max_pages_per_alloc_of_a_long_prompt():
    """The reference maps at most 64 pages at admission; the rest of a
    longer prompt's K/V is dropped, and decode maps only the page of the
    next token. The port does the same, and that lane breaks the paged
    kernel's contract, so the card serves it on the plain sub-batch."""
    jcfg = jreduced(jget("granite-3-8b"), dtype="float32", n_layers=1)
    pcfg = reduced(get_arch("granite-3-8b"), dtype="float32", n_layers=1)
    params = jt.init_params(jcfg, jax.random.PRNGKey(5))
    model = convert.lm_params_from_numpy(
        pcfg, jax.tree.map(np.asarray, params), "cpu")
    ecfg = dict(max_seqs=2, page_size=2, n_pages=100, max_len=160)
    prompts = [np.arange(2, 142, dtype=np.int32),
               np.arange(5, 15, dtype=np.int32)]
    je = jengine.Engine(jcfg, params, jengine.EngineConfig(**ecfg))
    pe = engine.Engine(pcfg, model, engine.EngineConfig(**ecfg),
                       device="cpu")
    js, ps = je.admit(je.init_state(), prompts), pe.admit(pe.init_state(),
                                                          prompts)
    for _ in range(2):
        js, ps = je.decode_step(js), pe.decode_step(ps)
        _same(js.table.page_table, ps.table.page_table)
        _same(js.tokens, ps.tokens)
    ps = pe.ensure_capacity(ps)
    mapped = ps.table.page_table.numpy() >= 0
    assert mapped[0, :kvc.MAX_PAGES_PER_ALLOC].all()
    assert not mapped[0, kvc.MAX_PAGES_PER_ALLOC:70].any()
    assert mapped[0, 70]      # the page of tokens 140-141
    np.testing.assert_array_equal(
        engine.kernel_lanes(ps.table.kv_len.numpy(), mapped, 2),
        [False, True])


# ------------------------------------------------- the reference's facts ----
@pytest.mark.parametrize("aid,differs", [("gemma2-27b", True),
                                         ("granite-3-8b", False)])
def test_engine_decode_order_is_the_references(aid, differs):
    """The engine runs each unit position's layer of every unit before the
    next position (gemma2: both local layers, then both global ones);
    ``transformer.decode_step`` runs the units in turn. With one layer a
    unit the two are the same computation."""
    pcfg = reduced(get_arch(aid))
    model = transformer.init_params(pcfg, torch.Generator().manual_seed(0),
                                    "cpu")
    eng = engine.Engine(pcfg, model, engine.EngineConfig(**ECFG),
                        device="cpu")
    assert eng.decode_order == ([0, 2, 1, 3] if differs else [0, 1, 2, 3][
        :pcfg.n_layers])
    prompt = np.arange(3, 19, dtype=np.int32)
    st = eng.admit(eng.init_state(), [prompt])
    _, logits = eng.decode_logits(st)
    _, cache = transformer.prefill(pcfg, model,
                                   {"tokens": torch.from_numpy(prompt[None])},
                                   ECFG["max_len"])
    ref, _ = transformer.decode_step(pcfg, model, cache, st.tokens[:1])
    gap = float((logits[0] - ref[0]).abs().max())
    if differs:
        assert gap > 1e-2
    else:
        assert gap <= 1e-5   # float32 sums in another order
