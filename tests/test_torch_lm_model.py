"""The port's LM model stack against the reference's, on the CPU.

Configurations: every arch id's ``ArchConfig`` (bit for bit, every
property), and ``reduced`` mixtral-8x22b (MoE, window 64), gemma2-27b
(softcaps, GELU, local/global units of 2), granite-3-8b and
nemotron-4-15b (``sq_relu``). Parameters come from the reference's
``init_params`` through ``convert.lm_params_from_numpy``; inputs are made
from a seed with numpy. In float32 the port's functions are held within
1e-5 of the reference's (``assert_allclose`` with rtol = atol = 1e-5); in
bfloat16 within ``BF16_TOL`` (the kernels' bfloat16 rule, 2e-2) scaled by
the output's largest value, since both sides round every intermediate
to bfloat16 and may round it to neighbouring values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS, SHAPES as J_SHAPES
from repro.configs import get_arch as jget, reduced as jreduced, \
    shape_applies as j_shape_applies
from repro.models import blocks as jblocks, common as jcommon, \
    moe as jmoe, transformer as jt

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, reduced, \
    shape_applies
from repro_torch.kernels.tolerance import LM_TOL
from repro_torch.models import api, blocks, common, moe, transformer

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = LM_TOL["bfloat16"]
MODEL_IDS = ("mixtral-8x22b", "gemma2-27b", "granite-3-8b",
             "nemotron-4-15b")


def _np(t):
    return convert.tensor_to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32 if np.asarray(t).dtype.name
                        == "bfloat16" else None)


def _close(ref, port, dtype="float32", what=""):
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape, (what, ref.shape, port.shape)
    if dtype == "float32":
        np.testing.assert_allclose(port, ref, err_msg=what, **F32)
    else:
        tol = BF16_TOL * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(port, ref, rtol=BF16_TOL, atol=tol,
                                   err_msg=what)


def _pair(a, dtype="float32"):
    """``a`` in ``dtype`` as a JAX array and as a port tensor, the same
    bits in both."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, convert.tensor_from_numpy(np.asarray(j))


def _configs(aid, dtype="float32", **kw):
    return (jreduced(jget(aid), dtype=dtype, **kw),
            reduced(get_arch(aid), dtype=dtype, **kw))


_MODELS = {}


def _model(aid, dtype="float32", **kw):
    """(reference config, params; port config, model), cached."""
    key = (aid, dtype, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg, pcfg = _configs(aid, dtype, **kw)
        params = jt.init_params(jcfg, jax.random.PRNGKey(0))
        model = convert.lm_params_from_numpy(
            pcfg, jax.tree.map(np.asarray, params), "cpu")
        _MODELS[key] = (jcfg, params, pcfg, model)
    return _MODELS[key]


def _tokens(vocab, B=2, S=24, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


# ------------------------------------------------------------ configs ----
def test_registry_matches_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}


def _props(cfg):
    u = cfg.unit()
    return dict(
        fields=dataclasses.astuple(cfg), d_head=cfg.d_head,
        mlp_kind=[cfg.mlp_kind(i) for i in range(cfg.n_layers)],
        layer_kind=[cfg.layer_kind(i) for i in range(cfg.n_layers)],
        unit_len=cfg.unit_len, unit=[dataclasses.astuple(s) for s in u],
        n_units=cfg.n_units, sub_quadratic=cfg.sub_quadratic,
        n_params=cfg.n_params(), n_active_params=cfg.n_active_params(),
        param_dtype=str(cfg.param_dtype).split(".")[-1]
        if isinstance(cfg.param_dtype, torch.dtype)
        else jnp.dtype(cfg.param_dtype).name)


@pytest.mark.parametrize("aid", ARCH_IDS)
@pytest.mark.parametrize("cut", [False, True], ids=["full", "reduced"])
def test_arch_config_properties_match_reference(aid, cut):
    j, p = jget(aid), get_arch(aid)
    if cut:
        j, p = jreduced(j), reduced(p)
    assert _props(p) == _props(j)
    for name, shape in SHAPES.items():
        assert shape_applies(p, shape) == j_shape_applies(j, J_SHAPES[name])


# ------------------------------------------------------------- common ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    rng = np.random.RandomState(1)
    xj, xp = _pair(rng.randn(2, 20, 4, 32) * 3, dtype)
    sj, sp = _pair(rng.randn(32) * 0.1)
    _close(jcommon.rms_norm(xj, sj, 1e-6), common.rms_norm(xp, sp, 1e-6),
           dtype, "rms_norm")
    pos = np.random.RandomState(2).randint(0, 5000, (2, 20)).astype(np.int32)
    for theta in (1e4, 1e6):
        rj = jcommon.rope(xj, jnp.asarray(pos), theta)
        rp = common.rope(xp, torch.from_numpy(pos), theta)
        assert rp.dtype == xp.dtype
        _close(rj, rp, dtype, f"rope theta {theta}")


@pytest.mark.parametrize("kind", ["silu", "gelu", "sq_relu"])
def test_activate_matches_reference(kind):
    xj, xp = _pair(np.random.RandomState(3).randn(64, 48) * 4)
    _close(jcommon.activate(xj, kind), common.activate(xp, kind),
           what=kind)


def test_activate_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        common.activate(torch.zeros(2), "relu6")


def test_embed_lookup_and_kv_cache_update_match_reference():
    rng = np.random.RandomState(4)
    ej, ep = _pair(rng.randn(50, 16))
    tok = rng.randint(0, 50, (3, 7)).astype(np.int32)
    _close(jcommon.embed_lookup(ej, jnp.asarray(tok)),
           common.embed_lookup(ep, torch.from_numpy(tok)))
    kc, vc = rng.randn(2, 4, 6, 3, 8), rng.randn(2, 4, 6, 3, 8)
    kn, vn = rng.randn(4, 3, 8), rng.randn(4, 3, 8)
    # positions inside, at the last slot, past the cache and negative
    pos = np.array([0, 5, 6, -2], np.int32)
    jk, jv = jcommon.kv_cache_update(*(jnp.asarray(a, jnp.float32)
                                       for a in (kc[0], vc[0], kn, vn)),
                                     jnp.asarray(pos))
    pk, pv = common.kv_cache_update(*(torch.tensor(a, dtype=torch.float32)
                                      for a in (kc[0], vc[0], kn, vn)),
                                    torch.from_numpy(pos))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


# ------------------------------------------------------------- blocks ----
def _layer(model, i):
    return model.layers[i]


def _jlayer(params, cfg, i):
    u, p = divmod(i, cfg.unit_len)
    return jax.tree.map(lambda a: a[u], params[f"u{p}"])


@pytest.mark.parametrize("aid", MODEL_IDS)
@pytest.mark.parametrize("window", [None, 8])
def test_attn_forward_and_decode_match_reference(aid, window):
    jcfg, params, pcfg, model = _model(aid)
    rng = np.random.RandomState(5)
    xj, xp = _pair(rng.randn(2, 20, jcfg.d_model))
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    jp = _jlayer(params, jcfg, 0)["attn"]
    pp = _layer(model, 0).attn
    yj, (kj, vj) = jblocks.attn_forward(jp, xj, jnp.asarray(pos), jcfg,
                                        window=window)
    for positions in (torch.from_numpy(pos), None):
        yp, (kp, vp) = blocks.attn_forward(pp, xp, positions, pcfg,
                                           window=window)
        _close(yj, yp, what="attn_forward y")
        _close(kj, kp, what="attn_forward k")
        _close(vj, vp, what="attn_forward v")
    # one token against a cache of 20, written at kv_len
    S = 24
    kc = np.zeros((2, S, jcfg.n_kv_heads, jcfg.d_head), np.float32)
    kc[:, :20], vc = np.asarray(kj), np.zeros_like(kc)
    vc[:, :20] = np.asarray(vj)
    kv_len = np.array([20, 17], np.int32)
    x1j, x1p = _pair(rng.randn(2, 1, jcfg.d_model))
    yj, (kj2, vj2) = jblocks.attn_decode(jp, x1j, jnp.asarray(kc),
                                         jnp.asarray(vc),
                                         jnp.asarray(kv_len), jcfg,
                                         window=window)
    yp, (kp2, vp2) = blocks.attn_decode(pp, x1p, torch.from_numpy(kc),
                                        torch.from_numpy(vc),
                                        torch.from_numpy(kv_len), pcfg,
                                        window=window)
    _close(yj, yp, what="attn_decode y")
    _close(kj2, kp2, what="attn_decode k cache")
    _close(vj2, vp2, what="attn_decode v cache")


def test_kv_override_and_recurrent_kinds_wait_for_slice_f2():
    """Slices F2a and F2b are ported: every architecture (the recurrent,
    hybrid, encoder-decoder and prefix-LM ones too) builds with the
    reference's parameter tree, leaf for leaf and shape for shape, and
    its layers in the reference's unit order."""
    for aid in ARCH_IDS:
        jcfg, pcfg = _configs(aid)
        params = jax.tree.map(np.asarray, jt.init_params(
            jcfg, jax.random.PRNGKey(0)))
        m = convert.lm_params_from_numpy(pcfg, params, "cpu")
        assert [layer.spec for layer in m.layers] \
            == pcfg.unit() * pcfg.n_units, aid
        back = convert.lm_params_to_numpy(m)
        assert jax.tree.structure(back) == jax.tree.structure(params), aid
        assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape,
                                                            params), aid
        assert hasattr(m, "encoder") == pcfg.is_encdec, aid


@pytest.mark.parametrize("aid", ["gemma2-27b", "granite-3-8b",
                                 "nemotron-4-15b"])
def test_mlp_forward_matches_reference(aid):
    jcfg, params, pcfg, model = _model(aid)
    xj, xp = _pair(np.random.RandomState(6).randn(3, 5, jcfg.d_model))
    _close(jblocks.mlp_forward(_jlayer(params, jcfg, 1)["mlp"], xj, jcfg),
           blocks.mlp_forward(_layer(model, 1).mlp, xp, pcfg))


def _moe_pair(T, cf, seed=7, dtype="float32", ties=False):
    jcfg, params, pcfg, model = _model("mixtral-8x22b", dtype)
    rng = np.random.RandomState(seed)
    x = rng.randn(T, jcfg.d_model)
    if ties:   # equal rows route equally: every choice a tie with itself
        x[1::2] = x[::2][: T // 2]
    xj, xp = _pair(x, dtype)
    jp = _jlayer(params, jcfg, 1)["moe"]
    yj, sj = jmoe.apply_moe(jp, xj, top_k=jcfg.top_k, capacity_factor=cf)
    yp, sp = moe.apply_moe(_layer(model, 1).moe, xp, top_k=pcfg.top_k,
                           capacity_factor=cf)
    return (yj, sj), (yp, sp)


@pytest.mark.parametrize("T,cf", [(32, 1.25), (32, 0.5), (8, 2.0),
                                  (5, 0.3)],
                         ids=["prefill", "overflow", "decode", "c1"])
def test_apply_moe_matches_reference(T, cf):
    (yj, sj), (yp, sp) = _moe_pair(T, cf)
    _close(yj, yp, what="y")
    np.testing.assert_array_equal(sp.load.numpy(), np.asarray(sj.load))
    assert sp.load.dtype == torch.int32
    _close(sj.dropped_fraction, sp.dropped_fraction, what="dropped")
    _close(sj.aux_loss, sp.aux_loss, what="aux")
    if cf < 1:
        assert float(sp.dropped_fraction) > 0   # the case overflows


def test_apply_moe_breaks_router_ties_toward_the_lower_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4]])
    vals, idx = moe.top_k_choices(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_apply_moe_bf16_within_tolerance():
    (yj, sj), (yp, sp) = _moe_pair(32, 1.25, dtype="bfloat16")
    _close(yj, yp, "bfloat16", "y")
    np.testing.assert_array_equal(sp.load.numpy(), np.asarray(sj.load))


def test_experts_use_silu_whatever_the_activation():
    """The reference's blocks call ``apply_moe`` without ``activation``,
    so a MoE config with GELU still runs SiLU experts."""
    jcfg, params, pcfg, model = _model("mixtral-8x22b", activation="gelu")
    xj, xp = _pair(np.random.RandomState(8).randn(2, 12, jcfg.d_model))
    pos = jnp.asarray(np.tile(np.arange(12, dtype=np.int32), (2, 1)))
    spec = pcfg.unit()[0]
    yj, _ = jblocks.layer_forward(_jlayer(params, jcfg, 0), xj, pos, jcfg,
                                  jcfg.unit()[0])
    yp, _ = blocks.layer_forward(_layer(model, 0), xp, None, pcfg, spec)
    _close(yj, yp, what="layer with GELU config")
    h2 = common.rms_norm(xp, _layer(model, 0).ln2, pcfg.norm_eps)
    silu = [moe.apply_moe(_layer(model, 0).moe, h2.reshape(24, -1),
                          top_k=2, activation=a)[0] for a in ("silu",
                                                              "gelu")]
    assert torch.equal(blocks.moe_block(_layer(model, 0), xp, pcfg,
                                        pcfg.capacity_factor).reshape(24, -1),
                       silu[0])
    assert not torch.allclose(silu[0], silu[1], atol=1e-4)


@pytest.mark.parametrize("aid", MODEL_IDS)
def test_layer_forward_and_decode_match_reference(aid):
    jcfg, params, pcfg, model = _model(aid)
    rng = np.random.RandomState(9)
    xj, xp = _pair(rng.randn(2, 16, jcfg.d_model))
    pos = jnp.asarray(np.tile(np.arange(16, dtype=np.int32), (2, 1)))
    for i in range(jcfg.unit_len):
        spec, jspec = pcfg.unit()[i], jcfg.unit()[i]
        yj, slot_j = jblocks.layer_forward(_jlayer(params, jcfg, i), xj, pos,
                                           jcfg, jspec)
        yp, slot_p = blocks.layer_forward(_layer(model, i), xp, None, pcfg,
                                          spec)
        _close(yj, yp, what=f"layer_forward {i}")
        _close(slot_j.k, slot_p.k, what="slot k")
        kc = np.zeros((2, 20, jcfg.n_kv_heads, jcfg.d_head), np.float32)
        kc[:, :16] = np.asarray(slot_j.k)
        vc = np.zeros_like(kc)
        vc[:, :16] = np.asarray(slot_j.v)
        kv_len = np.array([16, 11], np.int32)
        x1j, x1p = _pair(rng.randn(2, 1, jcfg.d_model))
        zj, cj = jblocks.layer_decode(
            _jlayer(params, jcfg, i), x1j,
            jblocks.LayerCacheSlot(k=jnp.asarray(kc), v=jnp.asarray(vc)),
            jnp.asarray(kv_len), jcfg, jspec)
        zp, cp = blocks.layer_decode(
            _layer(model, i), x1p,
            blocks.LayerCacheSlot(k=torch.from_numpy(kc),
                                  v=torch.from_numpy(vc)),
            torch.from_numpy(kv_len), pcfg, spec)
        _close(zj, zp, what=f"layer_decode {i}")
        _close(cj.k, cp.k, what="decode cache k")


# -------------------------------------------------------- transformer ----
@pytest.mark.parametrize("aid", MODEL_IDS)
def test_forward_prefill_and_decode_match_reference(aid):
    jcfg, params, pcfg, model = _model(aid)
    tok = _tokens(jcfg.vocab)
    hj, slots_j = jt.forward_hidden(jcfg, params, jnp.asarray(tok),
                                    collect_cache=True)
    hp, slots_p = transformer.forward_hidden(pcfg, model,
                                             torch.from_numpy(tok),
                                             collect_cache=True)
    _close(hj, hp, what="hidden")
    for i, s in enumerate(slots_p):
        u, p = divmod(i, pcfg.unit_len)
        _close(slots_j[p].k[u], s.k, what=f"layer {i} k")
        _close(slots_j[p].v[u], s.v, what=f"layer {i} v")
    m = api.build(pcfg)
    lj, cj = jt.prefill(jcfg, params, {"tokens": jnp.asarray(tok)}, 32)
    lp, cp = m.prefill(model, {"tokens": torch.from_numpy(tok)}, 32)
    _close(lj, lp, what="prefill last hidden")
    np.testing.assert_array_equal(cp.kv_len.numpy(), np.asarray(cj.kv_len))
    nxt = _tokens(jcfg.vocab, S=1, seed=1)[:, 0]
    for step in range(2):
        gj, cj = jt.decode_step(jcfg, params, cj, jnp.asarray(nxt))
        gp, cp = m.decode_step(model, cp, torch.from_numpy(nxt))
        _close(gj, gp, what=f"decode logits {step}")
        np.testing.assert_array_equal(cp.kv_len.numpy(),
                                      np.asarray(cj.kv_len))
        nxt = np.array(gj.argmax(-1), np.int32)
        assert np.array_equal(gp.argmax(-1).numpy(), nxt)


@pytest.mark.parametrize("aid", ["mixtral-8x22b", "gemma2-27b"])
def test_bf16_forward_and_decode_within_tolerance(aid):
    jcfg, params, pcfg, model = _model(aid, "bfloat16")
    tok = _tokens(jcfg.vocab, S=16)
    hj, _ = jt.forward_hidden(jcfg, params, jnp.asarray(tok))
    hp, _ = transformer.forward_hidden(pcfg, model, torch.from_numpy(tok))
    assert hp.dtype == torch.bfloat16
    _close(hj, hp, "bfloat16", "hidden")
    _, cj = jt.prefill(jcfg, params, {"tokens": jnp.asarray(tok)}, 20)
    _, cp = transformer.prefill(pcfg, model, {"tokens": torch.from_numpy(tok)},
                                20)
    nxt = tok[:, -1]
    gj, _ = jt.decode_step(jcfg, params, cj, jnp.asarray(nxt))
    gp, _ = transformer.decode_step(pcfg, model, cp, torch.from_numpy(nxt))
    _close(gj, gp, "bfloat16", "decode logits")


@pytest.mark.parametrize("aid", MODEL_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_through_convert(aid, dtype):
    jcfg, params, pcfg, model = _model(aid, dtype)
    assert next(model.parameters()).dtype == getattr(torch, dtype)
    back = convert.lm_params_to_numpy(model)
    same = jax.tree.map(lambda a, b: np.array_equal(
        np.asarray(a, np.float32), b) and np.asarray(a).shape == b.shape,
        params, back)
    assert all(jax.tree.leaves(same))
    again = convert.lm_params_from_numpy(pcfg, back, "cpu",
                                         dtype=getattr(torch, dtype))
    for (n, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a.float(), b.float()), n


def test_init_params_draws_every_weight_on_the_device():
    cfg = reduced(get_arch("mixtral-8x22b"))
    m = api.build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    again = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    for (n, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n
        assert bool(torch.isfinite(a.float()).all()), n
    assert m.embed.dtype == torch.bfloat16 and m.layers[0].ln1.dtype \
        == torch.float32
    assert float(m.layers[0].attn.wq.detach().float().std()) > 0
    assert not bool(m.layers[0].ln1.any())     # norm scales start at zero
