"""AdamW with decoupled weight decay and global-norm clipping
(``repro/train/optimizer.py``), linear warmup and cosine decay.

Parameters, gradients and the moments are trees keyed by the parameter's
name (``named_parameters``; a ``Transformer`` or any ``nn.Module`` is
taken for its named parameters). ``m`` and ``v`` are float32 whatever the
parameter's dtype; the update is computed in float32 and cast back to the
parameter's dtype, as the reference casts it: there is no float32 master
copy of a bfloat16 parameter.

``apply`` writes the new parameters, ``m`` and ``v`` **in place** (under
``torch.no_grad()``): at granite-3-8b's width a second copy of the
parameters and moments would cost as much again on the card. A caller
that must keep a step's values (a checkpoint) copies them first, as
``checkpoint/snapshot.save_async`` does before it returns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d: updates applied so far
    m: dict              # name → float32 first moment
    v: dict              # name → float32 second moment


def named(params) -> dict:
    """``params`` as a dict of name → tensor: a module's named
    parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init(params) -> AdamWState:
    ps = named(params)
    dev = next(iter(ps.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in ps.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v={n: z.clone() for n, z in zeros.items()})


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int32 tensor), float32: a linear
    warmup to ``lr`` over ``warmup_steps`` (``(step + 1) / warmup_steps``),
    then a cosine from ``lr`` down to ``0.1 · lr`` at ``total_steps``."""
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """The square root of the sum of every leaf's float32 squares."""
    vals = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in vals]).sum())


# leaves updated together by one multi-tensor launch per operation: at
# most this many elements, so that a group's float32 temporaries stay
# near 1 GB (a larger leaf is a group of its own)
GROUP_ELEMS = 1 << 26


def _groups(tensors: dict):
    """The names of ``tensors`` in groups of at most ``GROUP_ELEMS``
    elements, in order."""
    group, size = [], 0
    for n, t in tensors.items():
        if group and size + t.numel() > GROUP_ELEMS:
            yield group
            group, size = [], 0
        group.append(n)
        size += t.numel()
    if group:
        yield group


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step of ``params`` by ``grads`` (name → tensor, any
    float dtype), in place. ``step`` advances before the schedule is
    read, so the first update already runs at ``(1 + 1) / warmup_steps``
    of ``lr``. Returns ``(params, new state, {"grad_norm", "lr"})``;
    ``grad_norm`` is the norm before clipping.

    Each operation of the update runs over a group of leaves at once
    (``torch._foreach_*``), one float32 operation after another in the
    reference's order, so the result is that of a loop over the
    leaves."""
    ps = named(params)
    gnorm = global_norm([grads[n] for n in ps])
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.beta1 ** step.float()
    b2c = 1.0 - cfg.beta2 ** step.float()
    for group in _groups(ps):
        P = [ps[n] for n in group]
        M = [state.m[n] for n in group]
        V = [state.v[n] for n in group]
        # g = g.f32 · scale
        G = torch._foreach_mul([grads[n].float() for n in group], scale)
        # m = β1·m + (1 − β1)·g;  v = β2·v + (1 − β2)·g·g
        torch._foreach_mul_(M, cfg.beta1)
        torch._foreach_add_(M, torch._foreach_mul(G, 1 - cfg.beta1))
        torch._foreach_mul_(V, cfg.beta2)
        G2 = torch._foreach_mul(G, 1 - cfg.beta2)
        torch._foreach_mul_(G2, G)
        torch._foreach_add_(V, G2)
        del G, G2
        # δ = (m / b1c) / (√(v / b2c) + ε) + wd·p.f32
        den = torch._foreach_div(V, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(M, b1c)
        torch._foreach_div_(delta, den)
        del den
        pf = [p.float() for p in P]
        torch._foreach_add_(delta, torch._foreach_mul(pf, cfg.weight_decay))
        # p = (p.f32 − lr·δ) in p's dtype
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(pf, delta)
        for p, f in zip(P, pf):
            if f is not p:
                p.copy_(f)
        del delta, pf
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
