"""The port's recurrent layers and hybrid/recurrent models against the
reference's, on the CPU.

Cells: ``apply_mamba``, ``apply_mlstm`` and ``apply_slstm`` at prompt
lengths across ``d_conv - 1 = 3`` and the 64-step mLSTM chunk, without a
cache, with a given cache, and chained (a prompt in two calls, then one
decode token: mLSTM's at chunk 1, as ``layer_decode`` runs it); the
mamba layer's kernel route (the scan through the ``mamba_scan`` entry
point on float32 dt, x, B and C, which on the CPU is its plain version).
Models: reduced jamba-v0.1-52b and xlstm-350m, ``Model.prefill`` and 4
decode steps, logits and every cache leaf through
``convert.decode_cache_to_numpy``; each layer of their pattern units with
the reference's input; and the port's mirror of ``tests/test_archs.py``'s
prefill-plus-decode against the full forward.

Weights come from the reference's ``init_*`` and cross through
``convert``; inputs are made from seeds with numpy. float32 is held at
rtol = atol = 1e-5 (whole models, whose 16 layers and 70 sequential
steps sum float32 roundings in another order than XLA's, at atol 1e-5 of
the output's largest value); bfloat16 within ``BF16_TOL`` (2e-2) scaled
by the output's largest value, as ``test_torch_lm_model.py`` holds it.
In bfloat16 each layer is held on the reference's own input, not the
whole model: a rounding difference of one bfloat16 step in a layer's
input moves later layers by more than the rule. In jamba it can send a
token to another expert at a near tie (PERF.md §6); in xlstm the sLSTM's
exponential gating amplifies it from layer to layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget, reduced as jreduced
from repro.models import blocks as jblocks, recurrent as jrec, \
    transformer as jt

from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.tolerance import LM_TOL
from repro_torch.models import api, blocks, recurrent, transformer
from repro_torch.serve import engine

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = LM_TOL["bfloat16"]
LENGTHS = (1, 2, 3, 17, 64, 65, 130)
DTYPES = ("float32", "bfloat16")
D_MODEL, N_HEADS = 64, 4
RECURRENT_IDS = ("jamba-v0.1-52b", "xlstm-350m")


def _np(t):
    if isinstance(t, torch.Tensor):
        return convert.tensor_to_numpy(t)
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(ref, port, dtype="float32", what="", scaled=False):
    """``port`` against ``ref``: float32 at rtol = atol = 1e-5 (``scaled``:
    atol 1e-5 of ``ref``'s largest value), bfloat16 by the BF16_TOL
    rule."""
    ref, port = _np(ref), _np(port)
    assert ref.shape == port.shape, (what, ref.shape, port.shape)
    if dtype == "float32":
        atol = F32["atol"] * (max(1.0, float(np.abs(ref).max()))
                              if scaled else 1.0)
        np.testing.assert_allclose(port, ref, rtol=F32["rtol"], atol=atol,
                                   err_msg=what)
    else:
        tol = BF16_TOL * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(port, ref, rtol=BF16_TOL, atol=tol,
                                   err_msg=what)


def _close_state(ref, port, dtype, what, scaled=False):
    """Every leaf of a recurrent state (a NamedTuple) by field name."""
    assert type(port).__name__ == type(ref).__name__, what
    for f in port._fields:
        _close(getattr(ref, f), getattr(port, f), dtype, f"{what} {f}",
               scaled)


def _pair(a, dtype="float32"):
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, convert.tensor_from_numpy(np.asarray(j))


def _load(module, jparams):
    """``module`` with the reference's leaves ``jparams`` loaded (each
    parameter keeps its own dtype)."""
    module.load_state_dict({k: convert.tensor_from_numpy(np.asarray(v))
                            for k, v in jparams.items()})
    return module


# ---------------------------------------------------------------- cells ----
_CELLS = {}


def _cell(kind, dtype):
    """(reference params, port module, reference apply, port apply,
    reference cache type, port cache type) of one cell kind."""
    key = (kind, dtype)
    if key in _CELLS:
        return _CELLS[key]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    k = jax.random.PRNGKey(3)
    if kind == "mamba":
        jp = jrec.init_mamba(k, D_MODEL, dtype=jdt)
        pp = recurrent.Mamba(D_MODEL, dtype=tdt, device="cpu")
        fj, fp = jrec.apply_mamba, recurrent.apply_mamba
        types = (jrec.MambaCache, recurrent.MambaCache)
    elif kind == "mlstm":
        jp = jrec.init_mlstm(k, D_MODEL, N_HEADS, jdt)
        pp = recurrent.MLSTM(D_MODEL, N_HEADS, tdt, "cpu")
        fj = lambda p, x, c=None, **kw: jrec.apply_mlstm(  # noqa: E731
            p, x, c, n_heads=N_HEADS, **kw)
        fp = lambda p, x, c=None, **kw: recurrent.apply_mlstm(  # noqa: E731
            p, x, c, n_heads=N_HEADS, **kw)
        types = (jrec.MLSTMCache, recurrent.MLSTMCache)
    else:
        jp = jrec.init_slstm(k, D_MODEL, N_HEADS, jdt)
        pp = recurrent.SLSTM(D_MODEL, N_HEADS, tdt, "cpu")
        fj = lambda p, x, c=None: jrec.apply_slstm(  # noqa: E731
            p, x, c, n_heads=N_HEADS)
        fp = lambda p, x, c=None: recurrent.apply_slstm(  # noqa: E731
            p, x, c, n_heads=N_HEADS)
        types = (jrec.SLSTMCache, recurrent.SLSTMCache)
    _CELLS[key] = (jp, _load(pp, jp), fj, fp) + types
    return _CELLS[key]


def _given_cache(kind, dtype, B, rng):
    """A nonzero cache of ``kind``'s shapes as numpy arrays (the mamba
    conv state in the model's dtype, as a call leaves it)."""
    Di, N, Dh = 2 * D_MODEL, 16, D_MODEL // N_HEADS
    if kind == "mamba":
        return [(rng.randn(B, 3, Di), dtype), (rng.randn(B, Di, N) * 0.5,
                                               "float32")]
    if kind == "mlstm":
        return [(rng.randn(B, N_HEADS, Dh, Dh) * 0.3, "float32"),
                (rng.randn(B, N_HEADS, Dh) * 0.3, "float32"),
                (rng.uniform(-6, 0, (B, N_HEADS)), "float32")]
    return [(rng.randn(B, D_MODEL) * 0.5, "float32"),
            (rng.uniform(0.5, 3, (B, D_MODEL)), "float32"),
            (rng.randn(B, D_MODEL) * 0.5, "float32"),
            (rng.uniform(-6, 0, (B, D_MODEL)), "float32")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_cell_matches_reference(kind, S, dtype):
    jp, pp, fj, fp, jcache, pcache = _cell(kind, dtype)
    rng = np.random.RandomState(S)
    B = 2
    xj, xp = _pair(rng.randn(B, S, D_MODEL), dtype)
    what = f"{kind} S={S} {dtype}"
    # without a cache
    yj, cj = fj(jp, xj)
    yp, cp = fp(pp, xp)
    assert yp.dtype == xp.dtype
    _close(yj, yp, dtype, f"{what}: y")
    _close_state(cj, cp, dtype, f"{what}: cache")
    # with a given cache
    pairs = [_pair(a, dt) for a, dt in _given_cache(kind, dtype, B, rng)]
    yj, cj2 = fj(jp, xj, jcache(*(j for j, _ in pairs)))
    yp, cp2 = fp(pp, xp, pcache(*(t for _, t in pairs)))
    _close(yj, yp, dtype, f"{what}, given cache: y")
    _close_state(cj2, cp2, dtype, f"{what}, given cache: cache")
    # chained: the prompt in two calls, then one decode token
    cut = max(1, S // 2)
    x2j, x2p = (xj[:, cut:], xp[:, cut:]) if S > 1 else \
        _pair(rng.randn(B, 1, D_MODEL), dtype)
    yj, cj = fj(jp, xj[:, :cut])
    yp, cp = fp(pp, xp[:, :cut])
    yj, cj = fj(jp, x2j, cj)
    yp, cp = fp(pp, x2p, cp)
    _close(yj, yp, dtype, f"{what}, chained: y")
    _close_state(cj, cp, dtype, f"{what}, chained: cache")
    x3j, x3p = _pair(rng.randn(B, 1, D_MODEL), dtype)
    kw = dict(chunk=1) if kind == "mlstm" else {}
    yj, cj = fj(jp, x3j, cj, **kw)
    yp, cp = fp(pp, x3p, cp, **kw)
    _close(yj, yp, dtype, f"{what}, decode after the chain: y")
    _close_state(cj, cp, dtype, f"{what}, decode after the chain: cache")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 17, 65, 130])
def test_mamba_scan_route_matches_reference(S, dtype):
    """The layer's kernel route: the scan through the ``mamba_scan`` entry
    point on float32 dt, x, B and C (its plain version on the CPU), y and
    the last state, computes the reference's prefill."""
    jp, pp, fj, _, _, _ = _cell("mamba", dtype)
    xj, xp = _pair(np.random.RandomState(S + 50).randn(2, S, D_MODEL),
                   dtype)
    yj, cj = fj(jp, xj)
    zero = recurrent.mamba_init_cache(2, pp)
    yp, cp = recurrent._mamba_core(pp, xp @ pp.in_proj, zero.conv, zero.ssm,
                                   scan_kernel=True)
    _close(yj, yp, dtype, "y")
    _close_state(cj, cp, dtype, "cache")


def test_recurrent_leaves_keep_float32_and_reference_constants():
    """``dt_bias``, ``A_log``, ``D_skip``, ``w_if``, ``r``, ``bias`` and
    ``ln`` are float32 in a bfloat16 layer, and the deterministic ones are
    the reference's, drawn or not."""
    gen = torch.Generator().manual_seed(0)
    cpu = dict(generator=gen, device="cpu")
    for mod, jp in ((recurrent.init_mamba(D_MODEL, **cpu),
                     jrec.init_mamba(jax.random.PRNGKey(0), D_MODEL)),
                    (recurrent.Mamba(D_MODEL),
                     jrec.init_mamba(jax.random.PRNGKey(0), D_MODEL)),
                    (recurrent.init_mlstm(D_MODEL, N_HEADS, **cpu),
                     jrec.init_mlstm(jax.random.PRNGKey(0), D_MODEL,
                                     N_HEADS)),
                    (recurrent.init_slstm(D_MODEL, N_HEADS, **cpu),
                     jrec.init_slstm(jax.random.PRNGKey(0), D_MODEL,
                                     N_HEADS))):
        state = mod.state_dict()
        assert set(state) == set(jp)
        for name, t in state.items():
            ref = np.asarray(jp[name])
            assert t.shape == ref.shape, name
            assert str(t.dtype).split(".")[-1] == ref.dtype.name, name
            if name == "A_log":   # log 1..N: XLA's log is not always
                # correctly rounded (log 7 is one ulp off), torch's is
                np.testing.assert_array_max_ulp(t.numpy(), ref, maxulp=1)
            elif name in ("dt_bias", "D_skip", "bias", "ln"):
                np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)


# --------------------------------------------------------------- models ----
_MODELS = {}


def _model(aid, dtype="float32", **kw):
    """(reference config, params; port config, model), cached."""
    key = (aid, dtype, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg = jreduced(jget(aid), dtype=dtype, **kw)
        pcfg = reduced(get_arch(aid), dtype=dtype, **kw)
        params = jt.init_params(jcfg, jax.random.PRNGKey(0))
        model = convert.lm_params_from_numpy(
            pcfg, jax.tree.map(np.asarray, params), "cpu")
        _MODELS[key] = (jcfg, params, pcfg, model)
    return _MODELS[key]


def _jlayer(params, cfg, i):
    u, p = divmod(i, cfg.unit_len)
    return jax.tree.map(lambda a: a[u], params[f"u{p}"])


def _close_cache(ref, port, cfg, dtype, what):
    """Every leaf of the reference's DecodeCache against the port's in the
    reference's layout."""
    back = convert.decode_cache_to_numpy(cfg, port)
    np.testing.assert_array_equal(back.kv_len, np.asarray(ref.kv_len))
    for p, (rs, ps) in enumerate(zip(ref.slots, back.slots)):
        for f in blocks.LayerCacheSlot._fields:
            a, b = getattr(rs, f), getattr(ps, f)
            if isinstance(b, tuple) and not b:
                assert a == (), (what, p, f)
            elif hasattr(b, "_fields"):
                _close_state(a, b, dtype, f"{what} u{p} {f}", scaled=True)
            else:
                _close(a, b, dtype, f"{what} u{p} {f}", scaled=True)


@pytest.mark.parametrize("aid", RECURRENT_IDS)
def test_prefill_and_decode_match_reference(aid):
    dtype = "float32"
    jcfg, params, pcfg, model = _model(aid, dtype)
    tok = np.random.RandomState(0).randint(0, jcfg.vocab, (2, 70)) \
        .astype(np.int32)
    m = api.build(pcfg)
    hj, cj = jt.prefill(jcfg, params, {"tokens": jnp.asarray(tok)}, 80)
    hp, cp = m.prefill(model, {"tokens": torch.from_numpy(tok)}, 80)
    _close(hj, hp, dtype, "prefill last hidden", scaled=True)
    _close_cache(cj, cp, pcfg, dtype, "prefill cache")
    nxt = tok[:, -1]
    for step in range(4):
        gj, cj = jt.decode_step(jcfg, params, cj, jnp.asarray(nxt))
        gp, cp = m.decode_step(model, cp, torch.from_numpy(nxt))
        _close(gj, gp, dtype, f"decode logits {step}", scaled=True)
        _close_cache(cj, cp, pcfg, dtype, f"decode cache {step}")
        nxt = np.array(gj.argmax(-1), np.int32)


@pytest.mark.parametrize("aid", RECURRENT_IDS)
def test_decode_cache_round_trips_through_convert(aid):
    """The reference's cache → the port's → the reference's layout, leaf
    for leaf; a decode step from the converted cache is the port's own."""
    jcfg, params, pcfg, model = _model(aid)
    tok = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 9)) \
        .astype(np.int32)
    _, cj = jt.prefill(jcfg, params, {"tokens": jnp.asarray(tok)}, 12)
    cjn = jax.tree.map(np.asarray, cj)
    cp = convert.decode_cache_from_numpy(pcfg, cjn)
    assert len(cp.slots) == pcfg.n_layers
    back = convert.decode_cache_to_numpy(pcfg, cp)
    assert jax.tree.leaves(back) and all(
        np.array_equal(a, b) for a, b in zip(jax.tree.leaves(cjn),
                                             jax.tree.leaves(back)))
    nxt = torch.from_numpy(tok[:, -1])
    _, own = transformer.prefill(pcfg, model,
                                 {"tokens": torch.from_numpy(tok)}, 12)
    ga, _ = transformer.decode_step(pcfg, model, cp, nxt)
    gb, _ = transformer.decode_step(pcfg, model, own, nxt)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), **F32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aid", RECURRENT_IDS)
def test_layer_forward_and_decode_match_reference(aid, dtype):
    """Each layer of the pattern unit on the reference's input: prefill,
    then one decode token against its cache (attention's padded)."""
    jcfg, params, pcfg, model = _model(aid, dtype)
    rng = np.random.RandomState(9)
    xj, xp = _pair(rng.randn(2, 20, jcfg.d_model), dtype)
    pos = jnp.asarray(np.tile(np.arange(20, dtype=np.int32), (2, 1)))
    kv_len = np.array([20, 20], np.int32)
    for i in range(jcfg.unit_len):
        spec, jspec = pcfg.unit()[i], jcfg.unit()[i]
        jl = _jlayer(params, jcfg, i)
        yj, sj = jblocks.layer_forward(jl, xj, pos, jcfg, jspec)
        yp, sp = blocks.layer_forward(model.layers[i], xp, None, pcfg, spec)
        what = f"{aid} layer {i} ({spec.kind}, {spec.mlp})"
        _close(yj, yp, dtype, f"{what}: layer_forward")
        if spec.kind == "attn":
            pad = ((0, 0), (0, 4), (0, 0), (0, 0))
            sj = sj._replace(k=jnp.pad(sj.k, pad), v=jnp.pad(sj.v, pad))
            sp = sp._replace(
                k=torch.nn.functional.pad(sp.k, (0, 0, 0, 0, 0, 4)),
                v=torch.nn.functional.pad(sp.v, (0, 0, 0, 0, 0, 4)))
        x1j, x1p = _pair(rng.randn(2, 1, jcfg.d_model), dtype)
        zj, cj = jblocks.layer_decode(jl, x1j, sj, jnp.asarray(kv_len),
                                      jcfg, jspec)
        zp, cp = blocks.layer_decode(model.layers[i], x1p, sp,
                                     torch.from_numpy(kv_len), pcfg, spec)
        _close(zj, zp, dtype, f"{what}: layer_decode")
        state = getattr(cp, spec.kind, ())
        if spec.kind == "attn":
            _close(cj.k, cp.k, dtype, f"{what}: decode k")
            _close(cj.v, cp.v, dtype, f"{what}: decode v")
        else:
            _close_state(getattr(cj, spec.kind), state, dtype,
                         f"{what}: decode state")


@pytest.mark.parametrize("aid", RECURRENT_IDS)
@torch.no_grad()
def test_prefill_decode_matches_full_forward(aid):
    """``tests/test_archs.py``'s check on the port: teacher-forced decode
    reproduces the parallel forward's logits (dropless capacity, float32,
    within 2e-3)."""
    cfg = reduced(get_arch(aid), dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    m = api.build(cfg)
    model = m.init(torch.Generator().manual_seed(1), device="cpu")
    B, S = 2, 16
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (B, S)).astype(np.int32))
    hidden, _ = transformer.forward_hidden(cfg, model, tok)
    full = transformer.lm_head(hidden[:, -1], model.embed,
                               cfg.logit_softcap)
    _, cache = m.prefill(model, {"tokens": tok[:, :S - 1]}, S + 4)
    logits, cache = m.decode_step(model, cache, tok[:, S - 1])
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert cache.kv_len.tolist() == [S] * B


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aid", RECURRENT_IDS)
def test_params_round_trip_through_convert(aid, dtype):
    jcfg, params, pcfg, model = _model(aid, dtype)
    f32 = {"ln1", "ln2", "final_ln", "router", "dt_bias", "A_log", "D_skip",
           "w_if", "r", "bias", "ln"}
    for name, t in model.state_dict().items():
        want = torch.float32 if name.split(".")[-1] in f32 \
            else getattr(torch, dtype)
        assert t.dtype == want, name
    back = convert.lm_params_to_numpy(model)
    same = jax.tree.map(lambda a, b: np.array_equal(
        np.asarray(a, np.float32), b) and np.asarray(a).shape == b.shape,
        params, back)
    assert all(jax.tree.leaves(same))


def test_engine_refuses_recurrent_units():
    for aid in RECURRENT_IDS:
        cfg = reduced(get_arch(aid), dtype="float32")
        model = api.build(cfg).init(torch.Generator().manual_seed(0),
                                    device="cpu")
        with pytest.raises(ValueError, match="SSM archs use models/api"):
            engine.Engine(cfg, model, engine.EngineConfig(), device="cpu")
