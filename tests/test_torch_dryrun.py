"""The port's dry run (``launch/dryrun.py``) against the reference's HLO
counts, on the CPU.

Each reduced architecture's prefill and decode step, and the train step
(``make_train_step``: AdamW, ``nothing_saveable`` remat, 2 microbatches)
of two of them, is counted on meta tensors by the port's dispatch-level
counter and compiled by the reference, whose ``hlostats.analyze`` counts
the compiled HLO. The FLOPs are equal to the FLOP: there is no tolerance.

Two gaps that were seen between the packages are pinned with their
causes:

* paligemma-3b's decode differs by 2,048 FLOPs when the two packages'
  decodes run over caches of different lengths: 2,048 is one cache
  position of its decode attention (2 layers × 2 products × B 2 × 4 heads
  × 32 × 2). ``prefill`` pads the cache to ``max(max_len, S + 1)``, where
  S counts the 8-patch prefix, in both packages: over the same cache the
  counts are equal.
* jamba-v0.1-52b's train step counts more in the port: the gradient of
  the mamba readout ``einsum("bsdn,bsn->bsd")`` with respect to the
  states is an outer product, which autograd dispatches as a ``bmm``
  over a contraction of 1 and XLA's algebraic simplifier rewrites as a
  multiply, no ``dot``: ``2·B·S·Di·N`` FLOPs a mamba layer (14,680,064
  for the reduced model's 14 layers at B 2 × S 64).
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS, get_arch as jget, reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.launch import hlostats as jhs
from repro.models import build as jbuild, recurrent as jrec
from repro.train import optimizer as jopt
from repro.train.trainstep import make_train_step as jstep

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, hlostats
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api, recurrent

B, S = 2, 64


def _jflops(fn, *args):
    return jhs.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _ref_cell(aid, kind, n_micro=2):
    m = jbuild(jreduced(jget(aid)))
    shape = JShape(kind, S, B, kind)
    params = m.param_shapes()
    if kind == "train":
        return _jflops(jstep(m, jopt.AdamWConfig(), n_microbatches=n_micro),
                       params, jax.eval_shape(jopt.init, params),
                       m.input_specs(shape))
    if kind == "prefill":
        return _jflops(lambda p, b: m.prefill(p, b, max_len=S), params,
                       m.input_specs(shape))
    return _jflops(m.decode_step, params, m.cache_specs(shape),
                   m.input_specs(shape)["token"])


def _port_cell(aid, kind, n_micro=2):
    rec = dryrun.count_cell(reduced(get_arch(aid)),
                            ShapeConfig(kind, S, B, kind), make_host_mesh(),
                            n_micro)
    return rec["hlo_flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("aid", ARCH_IDS)
def test_serve_flops_equal_the_reference_hlo(aid, kind):
    assert _port_cell(aid, kind) == _ref_cell(aid, kind)


@pytest.mark.parametrize("aid", ["granite-3-8b", "mixtral-8x22b"])
def test_train_step_flops_equal_the_reference_hlo(aid):
    assert _port_cell(aid, "train") == _ref_cell(aid, "train")


def test_paligemma_decode_over_one_cache_is_equal():
    """The decode over the cache a 64-token prompt leaves (73 positions,
    the 8-patch prefix included, in both packages): equal."""
    aid = "paligemma-3b"
    jm, tm = jbuild(jreduced(jget(aid))), api.build(reduced(get_arch(aid)))
    cfg = tm.cfg
    batch = {"tokens": jnp.zeros((B, S), jnp.int32),
             "patches": jnp.zeros((B, cfg.prefix_len, cfg.d_model),
                                  jnp.bfloat16)}
    params = jm.param_shapes()
    cache = jax.eval_shape(lambda p: jm.prefill(p, batch, S)[1], params)
    ref = _jflops(jm.decode_step, params, cache,
                  jax.ShapeDtypeStruct((B,), jnp.int32))
    meta = {k: torch.empty(v.shape, device="meta", dtype=torch.int32
                           if k == "tokens" else cfg.param_dtype)
            for k, v in batch.items()}
    tp = tm.param_shapes()
    _, tc = tm.prefill(tp, meta, S, kernels=False)
    assert tc.slots[0].k.shape[1] == S + cfg.prefix_len + 1 == 73
    _, st = hlostats.count(tm.decode_step, tp, tc,
                           torch.empty((B,), dtype=torch.int32,
                                       device="meta"), kernels=False)
    assert st.flops == ref == 1_525_760
    # one cache position fewer is the 2,048 FLOPs seen between the two
    per_position = 2 * 2 * B * cfg.n_heads * cfg.d_head * cfg.n_layers
    assert per_position == 2_048


def test_jamba_train_gap_is_the_mamba_readout_outer_product():
    """A mamba layer's loss and gradients (the loss returned, so that no
    product is dead): the port counts exactly ``2·B·S·Di·N`` more, the
    outer product of the readout's gradient."""
    D, Bm, Sm = 64, 2, 16
    p = jrec.init_mamba(jax.random.PRNGKey(0), D, dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((Bm, Sm, D), jnp.float32)
    ref = _jflops(jax.value_and_grad(
        lambda p, x, w: (jrec.apply_mamba(p, x)[0] * w).sum()), p, x, x)
    tp = recurrent.Mamba(D, dtype=torch.float32, device="meta")
    for q in tp.parameters():
        q.requires_grad_(True)
    tx = torch.empty((Bm, Sm, D), device="meta")

    def step():
        loss = (recurrent.apply_mamba(tp, tx, kernels=False)[0] * tx).sum()
        return loss, torch.autograd.grad(loss, list(tp.parameters()))
    _, st = hlostats.count(step)
    Di, N = tp.A_log.shape
    assert st.flops - ref == 2 * Bm * Sm * Di * N
    # the reduced model's 14 mamba layers at B 2 × S 64
    cfg = reduced(get_arch("jamba-v0.1-52b"))
    n_mamba = sum(cfg.layer_kind(i)[0] == "mamba"
                  for i in range(cfg.n_layers))
    assert n_mamba * 2 * B * S * 2 * cfg.d_model * N == 14_680_064


def test_cli_writes_one_record_a_cell(tmp_path):
    dryrun.main(["--arch", "granite-3-8b", "--shape", "decode_32k",
                 "--mesh", "all", "--out", str(tmp_path)])
    dryrun.main(["--arch", "granite-3-8b", "--shape", "long_500k",
                 "--mesh", "card", "--out", str(tmp_path)])
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert sorted(recs) == sorted(
        [f"granite-3-8b__decode_32k__{m}.json"
         for m in ("card", "pod", "multipod")]
        + ["granite-3-8b__long_500k__card.json"])
    skip = recs["granite-3-8b__long_500k__card.json"]
    assert skip["status"] == "skip" and skip["reason"]
    card, pod = (recs[f"granite-3-8b__decode_32k__{m}.json"]
                 for m in ("card", "pod"))
    for r in (card, pod):
        assert r["status"] == "ok"
        assert set(r) >= {"hlo_flops", "hlo_bytes", "memory", "roofline",
                          "model_flops_total", "useful_flops_ratio",
                          "roofline_fraction", "dryrun_s", "top_ops"}
        assert r["roofline"]["dominant"] == "memory"
    # one step counts the same on every mesh; a chip of the pod holds a
    # 256th of the K/V (batch over data, sequence over model) and of
    # kv_len [128] int32 the 16th its data axis gives it
    assert card["hlo_flops"] == pod["hlo_flops"]
    assert pod["n_chips"] == 256 and card["n_chips"] == 1
    assert pod["memory"]["cache"] == (card["memory"]["cache"] - 512) \
        // 256 + 512 // 16
    assert not card["memory"]["fits_one_card"]
    assert pod["memory"]["fits_one_card"]
    cfg = get_arch("granite-3-8b")
    assert card["model_flops_total"] == 2 * cfg.n_active_params() * 128
