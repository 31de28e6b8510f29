"""The port's encoder-decoder and prefix-LM models against the reference's,
on the CPU.

Configurations: ``reduced`` whisper-medium (encoder-decoder: 2 encoder
layers over 16 frames, a cross-attention a decoder layer) and
paligemma-3b (prefix-LM: 8 patch embeddings before the tokens, one KV
head), d_model 128. Parameters come from the reference's ``init_params``
through ``convert.lm_params_from_numpy``; inputs (tokens, and the stub
frontends' frames and patches, 0.1·N(0, 1) as the reference's data
pipeline makes them) are drawn from a seed with numpy. In float32 the
port's functions are held within 1e-5 of the reference's; in bfloat16
within ``BF16_TOL`` scaled by the output's largest value, as
``tests/test_torch_lm_model.py`` holds the decoder-only models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget, reduced as jreduced
from repro.models import blocks as jblocks, common as jcommon, \
    transformer as jt

from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.tolerance import LM_TOL
from repro_torch.models import api, blocks, common, transformer

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = LM_TOL["bfloat16"]
ENCDEC_IDS = ("whisper-medium", "paligemma-3b")
DTYPES = ("float32", "bfloat16")


def _np(t):
    return convert.tensor_to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(np.asarray(t).astype(np.float32)
                        if np.asarray(t).dtype.name == "bfloat16" else t)


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


_MODELS = {}


def _model(aid, dtype="float32"):
    """(reference config, params; port config, model), cached."""
    key = (aid, dtype)
    if key not in _MODELS:
        jcfg = jreduced(jget(aid), dtype=dtype)
        pcfg = reduced(get_arch(aid), dtype=dtype)
        params = jt.init_params(jcfg, jax.random.PRNGKey(0))
        model = convert.lm_params_from_numpy(
            pcfg, jax.tree.map(np.asarray, params), "cpu")
        _MODELS[key] = (jcfg, params, pcfg, model)
    return _MODELS[key]


def _batch(cfg, dtype="float32", B=2, S=12, seed=0):
    """The prompt's tokens and the stub frontend's embeddings, as a
    reference batch and a port batch holding the same bits."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    jb, pb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    for name, n, on in (("frames", cfg.encoder_seq, cfg.is_encdec),
                        ("patches", cfg.prefix_len, cfg.is_prefix_lm)):
        if on:
            jb[name], pb[name] = _pair(
                0.1 * rng.randn(B, n, cfg.d_model), dtype)
    return jb, pb


def _prefix_inputs(cfg, params, model, jb, pb):
    """The reference's prefix-LM forward inputs (patches before the token
    embeddings, prefix_len for every row), and the port's."""
    xj = jcommon.embed_lookup(params["embed"], jb["tokens"])
    xj = jnp.concatenate([jb["patches"].astype(xj.dtype), xj], 1)
    xp = common.embed_lookup(model.embed, pb["tokens"])
    xp = torch.cat([pb["patches"].to(xp.dtype), xp], 1)
    plen = jnp.full((xj.shape[0],), cfg.prefix_len, jnp.int32)
    return xj, plen, xp


# ------------------------------------------------------------- encoder ----
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    jcfg, params, pcfg, model = _model("whisper-medium", dtype)
    jb, pb = _batch(jcfg, dtype)
    ej = jt.encode(jcfg, params, jb["frames"])
    ep = transformer.encode(pcfg, model, pb["frames"])
    assert ep.dtype == getattr(torch, dtype) and len(model.encoder.layers) \
        == jcfg.encoder_layers
    _close(ej, ep, dtype, "encoder output")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("queries", ["prompt", "decode", "keys_padded"])
def test_cross_attention_kv_override_matches_reference(queries, dtype):
    """The cross-attention's ``attn_forward`` with ``kv_override``: over a
    prompt at ``0..S-1``, one query a row roped at ``kv_len`` (as a decode
    step calls it), and with the encoder memory's positions given as a
    tensor whose last 5 keys are padding (-1e9), which the port keeps as
    given."""
    jcfg, params, pcfg, model = _model("whisper-medium", dtype)
    rng = np.random.RandomState(3)
    B, Se, Dh, Hkv = 2, jcfg.encoder_seq, jcfg.d_head, jcfg.n_kv_heads
    S = 1 if queries == "decode" else 9
    hj, hp = _pair(rng.randn(B, S, jcfg.d_model), dtype)
    ej, ep = _pair(0.5 * rng.randn(B, Se, jcfg.d_model), dtype)
    jp = jax.tree.map(lambda a: a[1], params["cross"])["attn"]
    pp = model.cross[1].attn
    kj = (ej @ jp["wk"]).reshape(B, Se, Hkv, Dh)
    vj = (ej @ jp["wv"]).reshape(B, Se, Hkv, Dh)
    kp = (ep @ pp.wk).reshape(B, Se, Hkv, Dh)
    vp = (ep @ pp.wv).reshape(B, Se, Hkv, Dh)
    enc_pos = np.tile(np.arange(Se, dtype=np.int32), (B, 1))
    pos_k = None
    if queries == "keys_padded":
        enc_pos[:, -5:] = -10 ** 9
        pos_k = torch.from_numpy(enc_pos)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    port_pos = None
    if queries == "decode":
        pos = np.array([[7], [13]], np.int32)
        port_pos = torch.from_numpy(pos)
    yj, (kj2, _) = jblocks.attn_forward(
        jp, hj, jnp.asarray(pos), jcfg, window=None, causal=False,
        kv_override=(kj, vj, jnp.asarray(enc_pos)))
    yp, (kp2, _) = blocks.attn_forward(
        pp, hp, port_pos, pcfg, window=None, causal=False,
        kv_override=(kp, vp, pos_k))
    _close(yj, yp, dtype, "cross-attention y")
    assert kp2 is kp     # the memory as given: no rope on k


# ------------------------------------------------------- prefix-LM mask ----
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", [1, 5, 8, 12, 20])
def test_prefix_attention_matches_chunked_attention(P, dtype):
    """The two-launch composition (a causal call over every row, then a
    non-causal one over the first P rows and keys) through the plain
    versions, against ``chunked_attention`` with ``prefix_len`` P for
    every row; P = S = 12 makes the whole call non-causal, P = 20 passes
    it."""
    rng = np.random.RandomState(P)
    B, S, Hq, Hkv, D = 2, 12, 4, 1, 32
    q, k, v = (convert.tensor_from_numpy(np.asarray(jnp.asarray(
        rng.randn(B, S, h, D), getattr(jnp, dtype))))
        for h in (Hq, Hkv, Hkv))
    pos = torch.arange(S)[None].expand(B, S)
    want = common.chunked_attention(
        q, k, v, positions_q=pos, positions_k=pos, causal=True,
        prefix_len=torch.full((B,), P, dtype=torch.int32))
    got = blocks.prefix_attention(q, k, v, P)
    assert got.dtype == q.dtype
    _close(want, got, dtype, f"prefix attention, P={P}")
    if P < S:   # the rows at P and above are the causal call's alone
        causal = flash_attention_ref(q, k, v, causal=True)
        assert torch.equal(got[:, P:], causal[:, P:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefix_attn_forward_matches_reference(dtype):
    """``attn_forward`` with ``prefix_len`` as the reference passes it
    ([B]) and as the port's prefill passes it (an int)."""
    jcfg, params, pcfg, model = _model("paligemma-3b", dtype)
    rng = np.random.RandomState(4)
    xj, xp = _pair(rng.randn(2, 14, jcfg.d_model), dtype)
    pos = jnp.asarray(np.tile(np.arange(14, dtype=np.int32), (2, 1)))
    jp = jax.tree.map(lambda a: a[0], params["u0"])["attn"]
    yj, (kj, vj) = jblocks.attn_forward(
        jp, xj, pos, jcfg, window=None,
        prefix_len=jnp.full((2,), jcfg.prefix_len, jnp.int32))
    for plen in (torch.full((2,), pcfg.prefix_len, dtype=torch.int32),
                 pcfg.prefix_len):
        yp, (kp, vp) = blocks.attn_forward(model.layers[0].attn, xp, None,
                                           pcfg, window=None,
                                           prefix_len=plen)
        _close(yj, yp, dtype, "prefix attn_forward y")
        _close(kj, kp, dtype, "prefix attn_forward k")
        _close(vj, vp, dtype, "prefix attn_forward v")


# --------------------------------------------------------- the models ----
@pytest.mark.parametrize("aid", ENCDEC_IDS)
def test_forward_hidden_matches_reference(aid):
    jcfg, params, pcfg, model = _model(aid)
    jb, pb = _batch(jcfg)
    if jcfg.is_encdec:
        ej = jt.encode(jcfg, params, jb["frames"])
        ep = transformer.encode(pcfg, model, pb["frames"])
        hj, slots_j = jt.forward_hidden(jcfg, params, jb["tokens"],
                                        enc_out=ej, collect_cache=True)
        hp, slots_p = transformer.forward_hidden(
            pcfg, model, pb["tokens"], enc_out=ep, collect_cache=True)
    else:
        xj, plen, xp = _prefix_inputs(jcfg, params, model, jb, pb)
        hj, slots_j = jt.forward_hidden(jcfg, params, xj, prefix_len=plen,
                                        collect_cache=True)
        hp, slots_p = transformer.forward_hidden(
            pcfg, model, xp, prefix_len=pcfg.prefix_len, collect_cache=True)
    _close(hj, hp, what="hidden")
    for i, s in enumerate(slots_p):
        u, p = divmod(i, pcfg.unit_len)
        _close(slots_j[p].k[u], s.k, what=f"layer {i} k")
        _close(slots_j[p].v[u], s.v, what=f"layer {i} v")


def _same_cache(cfg, cj, cp, dtype, what):
    """Every slot's K/V, ``enc_kv`` and ``kv_len`` of the port's cache
    against the reference's."""
    back = convert.decode_cache_to_numpy(cfg, cp)
    for p, (sj, sp) in enumerate(zip(cj.slots, back.slots)):
        _close(sj.k, sp.k, dtype, f"{what}: unit position {p} k")
        _close(sj.v, sp.v, dtype, f"{what}: unit position {p} v")
    assert len(cj.enc_kv) == len(back.enc_kv)
    for a, b in zip(cj.enc_kv, back.enc_kv):
        _close(a, b, dtype, f"{what}: enc_kv")
    np.testing.assert_array_equal(back.kv_len, np.asarray(cj.kv_len))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aid", ENCDEC_IDS)
def test_prefill_and_decode_match_reference(aid, dtype):
    """``Model.prefill`` (the last hidden state, every slot, ``enc_kv`` and
    ``kv_len``) and 4 ``decode_step`` s (logits and cache) on the
    reference's greedy tokens."""
    jcfg, params, pcfg, model = _model(aid, dtype)
    jb, pb = _batch(jcfg, dtype)
    m = api.build(pcfg)
    lj, cj = jt.prefill(jcfg, params, jb, 24)
    lp, cp = m.prefill(model, pb, 24, kernels=True)
    _close(lj, lp, dtype, "prefill last hidden")
    _same_cache(pcfg, cj, cp, dtype, "prefill")
    S = jb["tokens"].shape[1] + (jcfg.prefix_len if jcfg.is_prefix_lm
                                  else 0)
    assert cp.slots[0].k.shape[1] == max(24, S + 1)
    nxt = np.array(jb["tokens"])[:, -1]
    for step in range(4):
        gj, cj = jt.decode_step(jcfg, params, cj, jnp.asarray(nxt))
        gp, cp = m.decode_step(model, cp, torch.from_numpy(nxt))
        assert gp.dtype == torch.float32
        _close(gj, gp, dtype, f"decode logits {step}")
        _same_cache(pcfg, cj, cp, dtype, f"decode {step}")
        nxt = np.array(gj.argmax(-1), np.int32)


@pytest.mark.parametrize("aid", ENCDEC_IDS)
def test_prefill_then_decode_matches_full_forward(aid):
    """The port alone: teacher-forced decode of the last token after a
    prefill of the others gives the full forward's last logits (the
    reference's ``tests/test_archs.py`` check)."""
    _, _, pcfg, model = _model(aid)
    _, pb = _batch(pcfg, S=16, seed=1)
    tok = pb["tokens"]
    enc_out, plen, inputs = None, None, tok
    if pcfg.is_encdec:
        enc_out = transformer.encode(pcfg, model, pb["frames"])
    if pcfg.is_prefix_lm:
        x = common.embed_lookup(model.embed, tok)
        inputs = torch.cat([pb["patches"].to(x.dtype), x], 1)
        plen = pcfg.prefix_len
    with torch.no_grad():
        hidden, _ = transformer.forward_hidden(
            pcfg, model, inputs, prefix_len=plen, enc_out=enc_out)
        full = transformer.lm_head(hidden[:, -1], model.embed,
                                   pcfg.logit_softcap)
    m = api.build(pcfg)
    pre = dict(pb, tokens=tok[:, :-1])
    _, cache = m.prefill(model, pre, max_len=16 + pcfg.prefix_len + 4)
    logits, cache = m.decode_step(model, cache, tok[:, -1])
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
    assert cache.kv_len.tolist() == [inputs.shape[1]] * 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aid", ENCDEC_IDS)
def test_params_round_trip_through_convert(aid, dtype):
    jcfg, params, pcfg, model = _model(aid, dtype)
    assert next(model.parameters()).dtype == getattr(torch, dtype)
    back = convert.lm_params_to_numpy(model)
    same = jax.tree.map(lambda a, b: np.array_equal(
        np.asarray(a, np.float32), b) and np.asarray(a).shape == b.shape,
        params, back)
    assert all(jax.tree.leaves(same))
    assert set(back) == set(params)
    if jcfg.is_encdec:
        assert back["encoder"]["final_ln"].dtype == np.float32
        assert back["cross"]["ln"].shape == (jcfg.n_layers, jcfg.d_model)
    again = convert.lm_params_from_numpy(pcfg, back, "cpu",
                                         dtype=getattr(torch, dtype))
    for (n, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a.float(), b.float()), n


def test_init_params_draws_the_encoder_and_cross_attention():
    cfg = reduced(get_arch("whisper-medium"))
    m = api.build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert len(m.encoder.layers) == cfg.encoder_layers
    assert len(m.cross) == cfg.n_layers
    assert m.cross[0].ln.dtype == torch.float32 \
        and not bool(m.cross[0].ln.any())
    for name, w in m.named_parameters():
        assert bool(torch.isfinite(w.float()).all()), name
    for w in (m.encoder.layers[1].attn.wq, m.encoder.layers[0].mlp.w_out,
              m.cross[1].attn.wv):
        assert w.dtype == torch.bfloat16 \
            and float(w.detach().float().std()) > 0
