"""Gradient compression for the slow cross-pod reduction
(``repro/train/compression.py``).

* ``int8_compress``: stochastic-rounded int8 with a per-tensor scale
  (``max |x| / 127``): 8× smaller payloads than float32, unbiased.
* ``ef_apply``: error feedback, the quantisation error carried into the
  next step's residual instead of lost.

The stochastic-rounding noise is ``u - 0.5`` for uniform draws ``u`` in
[0, 1): a ``torch.Generator`` draws them, or ``rng`` is the draws
themselves (a tensor for one leaf; a list, one tensor a leaf in the tree's
order, for a tree), which is how a test feeds the reference's.

``pod_allreduce_compressed`` is the reference's int8 all-reduce over the
``pod`` mesh axis inside ``shard_map``. One card has no mesh; its analogue
takes the pods on a leading axis of every leaf (as the sharded store puts
its memory servers on one) and keeps the reference's arithmetic: each pod
quantises with **its own** scale, the int8 codes are summed as int32,
and the sum is multiplied by the **largest** scale and divided by the pod
count. That is the mean only when the pods' scales are equal.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._tree import leaves, rebuild, tmap


class EFState(NamedTuple):
    residual: object   # tree like the gradients, float32


def ef_init(grads_shape_tree) -> EFState:
    return EFState(residual=tmap(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_shape_tree))


def _uniform(rng, like: torch.Tensor) -> torch.Tensor:
    if isinstance(rng, torch.Generator):
        return torch.rand(like.shape, generator=rng,
                          device=rng.device).to(like.device)
    return torch.as_tensor(rng, dtype=torch.float32, device=like.device)


def int8_compress(x, rng):
    """Per-tensor-scale stochastic-rounding int8 quantization: ``(q int8,
    scale float32)``; ``rng`` a generator or the uniform draws."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    y = x32 / scale
    noise = _uniform(rng, y) - 0.5
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q, scale):
    return q.float() * scale


def _per_leaf(rng, n: int):
    return [rng] * n if isinstance(rng, torch.Generator) else list(rng)


def compress_tree(grads, rng):
    """Quantize a gradient tree: ``(int8 tree, scale tree)``."""
    xs = leaves(grads)
    out = [int8_compress(x, r) for x, r in zip(xs, _per_leaf(rng, len(xs)))]
    return rebuild(grads, iter([q for q, _ in out])), \
        rebuild(grads, iter([s for _, s in out]))


def decompress_tree(qs, scales):
    return tmap(int8_decompress, qs, scales)


def ef_apply(grads, ef: EFState, rng):
    """Error-feedback compression: quantize ``grad + residual``; the new
    residual keeps what quantization dropped. Returns ``(q tree, scale
    tree, new EFState)``."""
    corrected = tmap(lambda g, r: g.float() + r, grads, ef.residual)
    qs, scales = compress_tree(corrected, rng)
    recon = decompress_tree(qs, scales)
    return qs, scales, EFState(residual=tmap(lambda c, r: c - r, corrected,
                                             recon))


def pod_allreduce_compressed(grads, rng, ef: EFState | None = None):
    """The int8 mean over pods: every leaf of ``grads`` (and of ``ef``'s
    residual) has the pods on its leading axis. Each pod quantizes its
    own slice with its own scale (``rng``: a generator, or per pod the
    list of a leaf's draws); the codes are summed as int32 and scaled by
    the largest of the pods' scales over the pod count. Returns ``(the
    reduced tree, without the pod axis; the new EFState or None)``."""
    n = leaves(grads)[0].shape[0]
    per_pod = [rng] * n if isinstance(rng, torch.Generator) else list(rng)
    qs, scales, res = [], [], []
    for i in range(n):
        g_i = tmap(lambda g: g[i], grads)
        if ef is not None:
            q, s, e = ef_apply(g_i, EFState(tmap(lambda r: r[i],
                                                 ef.residual)), per_pod[i])
            res.append(e.residual)
        else:
            q, s = compress_tree(g_i, per_pod[i])
        qs.append(q)
        scales.append(s)
    summed = tmap(lambda *q: torch.stack([x.to(torch.int32) for x in q])
                  .sum(0, dtype=torch.int32), *qs)
    sc = tmap(lambda *s: torch.stack(s).amax(), *scales)
    out = tmap(lambda q, s: q.float() * s / n, summed, sc)
    if ef is not None:
        ef = EFState(residual=tmap(lambda *r: torch.stack(r), *res))
    return out, ef
