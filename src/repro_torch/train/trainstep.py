"""The train step (``repro/train/trainstep.py``): remat and microbatched
gradient accumulation.

``make_train_step`` returns ``step(params, opt_state, batch)``. The
global batch is split contiguously into ``n_microbatches``; each
microbatch's loss is differentiated by autograd on the plain path
(``Model.train_loss``: no kernel has a gradient), its gradients are
summed into float32 buffers, and the sums and the loss are divided by the
count before one AdamW update (``optimizer.apply``, in place).

Remat wraps the whole loss of a microbatch, mapping the reference's JAX
checkpoint policies onto ``torch.utils.checkpoint``:

  * ``nothing_saveable`` — a plain non-reentrant checkpoint: the backward
    pass recomputes the forward from the parameters and the batch;
  * ``dots_saveable`` — selective checkpointing that saves the outputs of
    matrix products (``aten.mm``, ``aten.bmm``, ``aten.addmm``) and
    recomputes the rest;
  * ``dots_with_no_batch_dims`` — the same without ``aten.bmm`` (the
    products with a batch dimension are recomputed).

None changes a value. ``grad_specs`` (and the policy's ``pin_grads``)
land each gradient in its parameter's sharding over a mesh; one card has
none, so they are accepted and have no effect.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.utils.checkpoint as ckpt

from repro_torch import policy as perf
from repro_torch._device import resolve_device
from repro_torch.models.api import Model
from repro_torch.train import optimizer as opt

REMAT_POLICIES = ("nothing_saveable", "dots_saveable",
                  "dots_with_no_batch_dims")


def _saved_ops(policy: str):
    aten = torch.ops.aten
    ops = {aten.mm.default, aten.addmm.default}
    if policy == "dots_saveable":
        ops.add(aten.bmm.default)
    return ops


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the checkpoint policy ``policy`` (module docstring)."""
    if policy not in REMAT_POLICIES:
        raise KeyError(f"unknown remat policy {policy!r}; known: "
                       f"{REMAT_POLICIES}")
    if policy == "nothing_saveable":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if not hasattr(ckpt, "create_selective_checkpoint_contexts"):
        raise RuntimeError(
            f"remat policy {policy!r} needs torch.utils.checkpoint."
            f"create_selective_checkpoint_contexts, which this PyTorch "
            f"({torch.__version__}) lacks")
    saved = _saved_ops(policy)

    def choose(ctx, op, *args, **kwargs):
        return ckpt.CheckpointPolicy.MUST_SAVE if op in saved \
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                choose)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                             context_fn=context)


def split_microbatches(batch: dict, n_micro: int) -> list:
    """``n_micro`` batches of consecutive rows of every leaf of
    ``batch``."""
    def split(x):
        B = x.shape[0]
        assert B % n_micro == 0, (B, n_micro)
        return x.reshape((n_micro, B // n_micro) + x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def make_train_step(model: Model, opt_cfg: opt.AdamWConfig,
                    n_microbatches: int = 1,
                    remat_policy: Optional[str] = None,
                    grad_specs=None, *, device=None) -> Callable:
    """Build the train step of one architecture on ``device`` (the card
    unless the CPU is asked for; the step raises without a card).

    ``remat_policy`` and ``n_microbatches`` default from the active
    PerfPolicy (``repro_torch.policy``), as the reference's do. The step
    takes the parameters (a ``Transformer``) on the device, their
    ``AdamWState`` and a batch (moved to the device), and returns
    ``(params, opt_state, metrics)``, the parameters and moments updated
    in place; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``."""
    pol = perf.current()
    if remat_policy is None:
        remat_policy = pol.remat
    if pol.n_microbatches is not None:
        n_microbatches = pol.n_microbatches
    loss_fn = remat(model.train_loss, remat_policy)
    del grad_specs          # no sharding on one card (module docstring)

    def step(params, opt_state, batch):
        loss, grads = grads_and_loss(loss_fn, params, batch, n_microbatches,
                                     resolve_device(device))
        params, opt_state, metrics = opt.apply(opt_cfg, params, grads,
                                               opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def grads_and_loss(loss_fn: Callable, params, batch: dict,
                   n_microbatches: int, device):
    """The mean loss over ``n_microbatches`` contiguous microbatches of
    ``batch`` and the mean gradients (name → float32): each microbatch's
    ``loss_fn(params, mb)`` differentiated by autograd, its gradients
    summed into float32 buffers, the sums and the loss divided by the
    count."""
    names, ps = zip(*params.named_parameters())
    device = torch.device(device)
    if any(p.device.type != device.type or device.index not in (
            None, p.device.index) for p in ps):
        raise ValueError(f"train step on {device}: the parameters are on "
                         f"{ps[0].device}")
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=device)
            for p in ps]
    lsum = torch.zeros((), dtype=torch.float32, device=device)
    batch = {k: v.to(device) for k, v in batch.items()}
    for mb in split_microbatches(batch, n_microbatches):
        with torch.enable_grad():
            loss = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        for a, g in zip(gsum, grads):
            if g is not None:           # a leaf the loss never reads
                a += g.float()
        del grads
        lsum = lsum + loss.detach()
    return lsum / n_microbatches, {n: g.div_(n_microbatches)
                                   for n, g in zip(names, gsum)}


def make_eval_step(model: Model) -> Callable:
    def step(params, batch):
        return model.train_loss(params, batch)
    return step
