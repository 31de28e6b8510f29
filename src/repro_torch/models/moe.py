"""Mixture-of-Experts layer (``repro/models/moe.py``): top-k router and
capacity-based grouped dispatch.

Dispatch is sort-free (rank within an expert by a masked cumsum) and
capacity-bounded: expert e takes at most ``C = max(1, int(cf·T·k/E))`` of
the (token, choice) pairs routed to it, in token order, and a pair past
that is dropped into a sink expert row that the FFN never sees. The grouped
expert FFN over the ``[E, C, D]`` buckets is ``kernels/moe_gmm`` on the
card; on the CPU, and on the card's plain path, it is the reference's
three einsums in the parameters' dtype. The combine accumulates in
float32.

The reference's ``apply_moe_sharded`` dispatches per data shard inside
``shard_map`` over a device mesh; one card has no mesh, so only the
global formulation is ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.models import common


class MoE(nn.Module):
    """Router ``[D, E]`` (float32) and the experts' ``w_gate``/``w_in``
    ``[E, D, F]`` and ``w_out`` ``[E, F, D]``; drawn from ``generator``
    when one is given, else left uninitialised."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, dtype,
                 device=None, generator=None):
        super().__init__()

        def empty(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = empty(d_model, n_experts, dt=torch.float32)
        self.w_gate = empty(n_experts, d_model, d_ff)
        self.w_in = empty(n_experts, d_model, d_ff)
        self.w_out = empty(n_experts, d_ff, d_model)
        if generator is not None:
            for name, w in self.named_parameters():
                common.normal_(w, (d_ff if name == "w_out" else d_model)
                               ** -0.5, generator)


def init_moe(d_model: int, d_ff: int, n_experts: int, dtype, *, generator,
             device=None) -> MoE:
    return MoE(d_model, d_ff, n_experts, dtype, device, generator)


class MoEStats(NamedTuple):
    dropped_fraction: torch.Tensor   # tokens over capacity
    load: torch.Tensor               # int32 [E] tokens per expert
    aux_loss: torch.Tensor           # load-balancing loss (Switch-style)


def top_k_choices(probs, k: int):
    """``(values, indices)`` of the k largest entries of each row, ties
    broken toward the lower index as ``jax.lax.top_k`` breaks them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p, x, *, top_k: int, capacity_factor: float = 1.25,
              activation: str = "silu", kernels: bool = True):
    """x: [T, D] (already flattened). Returns (y [T, D], MoEStats).

    ``kernels`` lets a CUDA call run the grouped FFN as the ``moe_gmm``
    kernel (on the CPU it has no effect)."""
    T, D = x.shape
    E = p.router.shape[1]
    logits = x.float() @ p.router                             # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_choices(probs, top_k)       # [T, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    C = max(1, int(capacity_factor * T * top_k / E))
    # rank of each (token, choice) within its expert, in token order
    flat_e = expert_idx.reshape(-1)                           # [T*k]
    onehot = F.one_hot(flat_e, E).to(torch.int32)             # [T*k, E]
    rank = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    my_rank = rank.gather(1, flat_e[:, None])[:, 0]
    keep = my_rank < C
    load = onehot.sum(dim=0, dtype=torch.int32)

    # tokens into [E, C, D] buckets; a dropped choice goes to sink row E
    tok_of_flat = torch.arange(T, device=x.device).repeat_interleave(top_k)
    e_idx = torch.where(keep, flat_e, E)
    c_idx = torch.where(keep, my_rank, 0)
    buckets = x.new_zeros((E + 1, C, D))
    buckets[e_idx, c_idx] = x[tok_of_flat]
    buckets = buckets[:E]

    if kernels and x.is_cuda:
        out = moe_ops.moe_gmm(buckets, p.w_gate, p.w_in, p.w_out,
                              activation=activation)
    else:
        g = torch.einsum("ecd,edf->ecf", buckets, p.w_gate)
        h = torch.einsum("ecd,edf->ecf", buckets, p.w_in)
        h = common.activate(g, activation) * h
        out = torch.einsum("ecf,efd->ecd", h, p.w_out)        # [E, C, D]

    # combine back, weighted by the (renormalised) gates
    contrib = out[torch.where(keep, flat_e, 0), c_idx]        # [T*k, D]
    w = torch.where(keep, gate_vals.reshape(-1), 0.0)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok_of_flat, contrib.float() * w[:, None])

    # Switch-style load-balancing auxiliary loss
    me = probs.mean(dim=0)
    ce = load.float() / torch.clamp(load.sum(), min=1)
    aux = E * (me * ce).sum()
    stats = MoEStats(dropped_fraction=1.0 - keep.sum() / (T * top_k),
                     load=load, aux_loss=aux)
    return y.to(x.dtype), stats
