"""``Model.train_loss`` and every gradient leaf against ``jax.value_and_
grad`` of the reference's, on the CPU, at each architecture's ``reduced``
configuration with B = 2 and S = 16 (the ten arch ids are split over this
file and ``test_torch_train_models_b.py``, so that xdist spreads them).


Parameters come from the reference's ``init_params`` through
``convert.lm_params_from_numpy``, the batch (tokens, targets, a mask with
zeros, and ``frames`` or ``patches``) from a numpy seed, and the port's
gradients reach the reference's stacked tree through
``convert.grads_to_numpy``. In float32 the loss is held within
``F32_LOSS_RTOL`` and each gradient leaf within a relative RMS difference
of ``F32_GRAD_RRMS``; granite-3-8b and mixtral-8x22b are also held in
bfloat16, where both sides round every intermediate (and a MoE route may
flip), to ``BF16_LOSS_RTOL`` and ``BF16_GRAD_RRMS``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget, reduced as jreduced
from repro.models import api as japi

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.models import api

# limits, each beside the largest reading over the ten architectures
F32_LOSS_RTOL = 1e-6     # read: 2.2e-7
F32_GRAD_RRMS = 3e-5     # read: 1.0e-5 (jamba's mamba x_proj)
BF16_LOSS_RTOL = 2e-3    # read: 6.3e-4 (mixtral)
BF16_GRAD_RRMS = 5e-2    # read: 1.7e-2 (granite's wq)

# this file's half of the ten; test_torch_train_models_b.py has the rest
ARCHS_A = ("mixtral-8x22b", "granite-moe-1b-a400m", "xlstm-350m",
           "whisper-medium", "granite-3-8b", "h2o-danube-3-4b")


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
         "targets": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
         "mask": (rng.rand(B, S) > 0.2).astype(np.float32)}
    if cfg.is_encdec:
        b["frames"] = 0.1 * rng.randn(B, cfg.encoder_seq, cfg.d_model)
    if cfg.is_prefix_lm:
        b["patches"] = 0.1 * rng.randn(B, cfg.prefix_len, cfg.d_model)
    return {k: jnp.asarray(v, cfg.param_dtype if v.dtype == np.float64
                           else None) for k, v in b.items()}


def _rel_rms(ref, port):
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port, np.float64)
    den = np.sqrt((ref ** 2).mean())
    num = np.sqrt(((ref - port) ** 2).mean())
    return num / den if den else num


def check_train_loss_and_grads(aid, dtype):
    """The loss and every gradient leaf of reduced ``aid`` in ``dtype``
    against the reference's."""
    jcfg = jreduced(jget(aid), dtype=dtype)
    cfg = reduced(get_arch(aid), dtype=dtype)
    params = japi.build(jcfg).init(jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), "cpu")
    jb = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(japi.build(jcfg).train_loss)(
        params, jb)
    batch = {k: convert.tensor_from_numpy(np.asarray(v))
             for k, v in jb.items()}
    loss = api.build(cfg).train_loss(model, batch)
    assert loss.dtype == torch.float32
    names, ps = zip(*model.named_parameters())
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = convert.grads_to_numpy(model, {
        n: g if g is not None else torch.zeros_like(p)
        for n, g, p in zip(names, gs, ps)})
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=F32_LOSS_RTOL if f32 else BF16_LOSS_RTOL)
    limit = F32_GRAD_RRMS if f32 else BF16_GRAD_RRMS
    n_leaves = 0
    for path, a in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        b = grads
        for k in path:
            b = b[k.key]
        assert b.shape == a.shape, path
        a = np.asarray(a, np.float32)
        if not a.any():          # a leaf the loss never reads
            assert not b.any(), path
        else:
            r = _rel_rms(a, b)
            assert r <= limit, (jax.tree_util.keystr(path), r)
        n_leaves += 1
    assert n_leaves == len(jax.tree.leaves(grads))


@pytest.mark.parametrize("aid", ARCHS_A)
def test_train_loss_and_grads_match_reference(aid):
    check_train_loss_and_grads(aid, "float32")


def test_train_loss_and_grads_bf16_within_tolerance_granite():
    check_train_loss_and_grads("granite-3-8b", "bfloat16")


def test_the_two_files_cover_every_arch():
    from test_torch_train_models_b import ARCHS_B
    assert sorted(ARCHS_A + ARCHS_B) == sorted(ARCH_IDS)


def test_padding_rows_of_the_last_chunk_add_nothing():
    """``chunked_cross_entropy`` over S = 1,100 (a second, padded chunk)
    equals the sum of its two parts' losses; the tied head's gradient
    gets nothing from the padding rows."""
    from repro_torch.models import common
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 1100, 16, generator=g)
    emb = torch.randn(50, 16, generator=g, requires_grad=True)
    t = torch.randint(0, 50, (2, 1100), generator=g)
    m = (torch.rand(2, 1100, generator=g) > 0.3).float()
    loss, w = common.chunked_cross_entropy(h, emb, t, m, logit_cap=30.0)
    logits = common.softcap(h @ emb.T, 30.0)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, t[..., None])[..., 0]
    want = (nll * m).sum() / m.sum()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    assert float(w) == float(m.sum())
    ge, = torch.autograd.grad(loss, emb)
    gw, = torch.autograd.grad(want, emb)
    torch.testing.assert_close(ge, gw, rtol=1e-5, atol=1e-7)
