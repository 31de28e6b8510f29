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

Under a policy with ``constrain_activations`` (``opt``) and a live mesh
with ``data`` and ``model`` axes (``launch/mesh.py``), ``apply_moe``
takes :func:`apply_moe_sharded`, the reference's ``shard_map`` dispatch:
each data shard routes its own tokens against a local capacity, and the
tensor-parallel slices of the expert FFN are summed. One card holds
every shard: the shards are a leading axis of one tensor, and the grouped
FFN of all of them is one ``moe_gmm`` launch a model slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import policy
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
    kernel (on the CPU it has no effect). Under the ``opt`` policy and a
    live mesh whose axes divide the tokens, the FFN width and the model
    width this dispatches to :func:`apply_moe_sharded`, as the reference
    does; otherwise it is the global dispatch, one shard of it."""
    axes = common._mesh_axes()
    T, D = x.shape
    n_ff = p.w_in.shape[2]
    if policy.current().constrain_activations and axes \
            and "model" in axes and "data" in axes \
            and T % common._axis_size(common._dp(axes)) == 0 \
            and n_ff % common._axis_size("model") == 0 \
            and D % common._axis_size("model") == 0:
        return apply_moe_sharded(p, x, top_k=top_k,
                                 capacity_factor=capacity_factor,
                                 activation=activation, kernels=kernels)
    return _dispatch(p, x, 1, 1, top_k=top_k,
                     capacity_factor=capacity_factor, activation=activation,
                     kernels=kernels)


def apply_moe_sharded(p, x, *, top_k: int, capacity_factor: float,
                      activation: str = "silu", kernels: bool = True):
    """The reference's ``shard_map`` dispatch over the live mesh: |dp|
    data shards (dp: ``data``, with ``pod`` in front when the mesh has
    one) and |model| slices of the FFN width (:func:`_dispatch`).
    Returns (y [T, D], MoEStats)."""
    axes = common._mesh_axes()
    return _dispatch(p, x, common._axis_size(common._dp(axes)),
                     common._axis_size("model"), top_k=top_k,
                     capacity_factor=capacity_factor, activation=activation,
                     kernels=kernels)


def _expert_ffn(buckets, w_gate, w_in, w_out, activation: str):
    """The three einsums of the grouped FFN over ``[..., E, C, D]``
    buckets, in the weights' dtype."""
    g = torch.einsum("...ecd,edf->...ecf", buckets, w_gate)
    h = torch.einsum("...ecd,edf->...ecf", buckets, w_in)
    h = common.activate(g, activation) * h
    return torch.einsum("...ecf,efd->...ecd", h, w_out)


def _dispatch(p, x, n_dp: int, n_model: int, *, top_k: int,
              capacity_factor: float, activation: str, kernels: bool):
    """The dispatch over ``n_dp`` data shards, a leading axis: x [T, D] →
    [n_dp, T_l, D]. Each shard routes its own tokens, ranks each (token,
    choice) within its expert in its own token order (a masked cumsum)
    and keeps at most ``C_l = max(1, int(cf·T_l·k/E))`` an expert; a
    dropped choice goes to a sink row that the FFN never sees. ``load``,
    the mean router probability, the kept count and the total are summed
    over the shards, as the reference's ``psum``s are; the combine is
    local and accumulates in float32. One shard is the global dispatch.

    ``n_model`` slices of the FFN width F: each slice's ``[E, C_l, D]``
    partial output is cast to x's dtype and the partials are summed, as
    the reference casts before its ``psum_scatter``. On the card
    (``kernels``) the shards' buckets ``[n_dp, E, C_l, D]`` are laid out
    as ``[E, n_dp·C_l, D]``, since every shard holds the same experts, and
    the grouped FFN of all the shards is one ``moe_gmm`` launch a slice;
    on the CPU, and with ``kernels=False``, it is the three einsums."""
    T, D = x.shape
    E = p.router.shape[1]
    probs = torch.softmax(x.float() @ p.router, dim=-1)       # [T, E]
    gate_vals, expert_idx = top_k_choices(probs, top_k)       # [T, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    Tl = T // n_dp
    xl = x.reshape(n_dp, Tl, D)
    C = max(1, int(capacity_factor * Tl * top_k / E))
    flat_e = expert_idx.reshape(n_dp, Tl * top_k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)             # [dp, Tl*k, E]
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    my_rank = rank.gather(2, flat_e[..., None])[..., 0]       # [dp, Tl*k]
    keep = my_rank < C
    load = onehot.sum(dim=(0, 1), dtype=torch.int32)

    # tokens into [dp, E, C, D] buckets; a dropped choice goes to sink row E
    shard = torch.arange(n_dp, device=x.device)[:, None]      # [dp, 1]
    tok_of_flat = torch.arange(Tl, device=x.device) \
        .repeat_interleave(top_k)[None]                       # [1, Tl*k]
    e_idx = torch.where(keep, flat_e, E)
    c_idx = torch.where(keep, my_rank, 0)
    buckets = x.new_zeros((n_dp, E + 1, C, D))
    buckets[shard, e_idx, c_idx] = xl[shard, tok_of_flat]
    buckets = buckets[:, :E]

    card = kernels and x.is_cuda
    if card:    # every shard's rows of an expert together: [E, dp·C, D]
        rows = buckets.transpose(0, 1).reshape(E, n_dp * C, D)
    out = None
    Fs = p.w_in.shape[2] // n_model
    for j in range(n_model):
        sl = slice(j * Fs, (j + 1) * Fs)
        w = (p.w_gate[:, :, sl], p.w_in[:, :, sl], p.w_out[:, sl])
        if card:
            part = moe_ops.moe_gmm(rows, *(t.contiguous() for t in w),
                                   activation=activation)
            part = part.reshape(E, n_dp, C, D).transpose(0, 1)
        else:
            part = _expert_ffn(buckets, *w, activation)
        part = part.to(x.dtype)
        out = part if out is None else out + part

    # combine back, weighted by the (renormalised) gates
    contrib = out[shard, torch.where(keep, flat_e, 0), c_idx]  # [dp, Tl*k, D]
    gw = torch.where(keep, gate_vals.reshape(n_dp, -1), 0.0)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    y.index_add_(0, (shard * Tl + tok_of_flat).reshape(-1),
                 (contrib.float() * gw[..., None]).reshape(-1, D))

    # Switch-style load-balancing auxiliary loss
    me = probs.mean(dim=0)
    ce = load.float() / torch.clamp(load.sum(), min=1)
    aux = E * (me * ce).sum()
    stats = MoEStats(dropped_fraction=1.0 - keep.sum() / (T * top_k),
                     load=load, aux_loss=aux)
    return y.to(x.dtype), stats
