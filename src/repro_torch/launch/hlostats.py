"""A dispatch-level op counter (``repro/launch/hlostats.py``).

The reference parses the compiled HLO text of a step and totals its
``dot`` and ``convolution`` FLOPs and the HBM bytes of its scheduled
instructions, with while-loop trip counts. Eager PyTorch has no compiled
program: the counterpart counts what the step *dispatches*, op by op,
under a ``TorchDispatchMode``. It works on ``meta`` tensors, so a step of
any size is counted with no allocation (``launch/dryrun.py``), and on
real tensors too.

  * **flops** — ``2 · out_elems · prod(contracted dims)`` for ``mm``,
    ``bmm``, ``addmm`` and ``baddbmm`` (``einsum``, ``matmul`` and
    ``linear`` reach the dispatcher as these), as the reference's
    ``_dot_flops``; for ``convolution``, ``2 · out_elems ·
    in_channels/groups · prod(kernel window)``, the exact count of which
    the reference's ``_conv_flops`` is an estimate (neither model family
    dispatches one).
  * **hbm_bytes** — the bytes of each non-view op's tensor inputs plus
    its outputs: the unfused traffic eager mode moves, where the reference
    counts scheduled HLO instructions. As in the reference's
    ``_instr_bytes``, a gather moves its slice (read and written) and its
    indices, and a write into part of a tensor (``index_put_``,
    ``index_add_``, ``scatter``) its values (read and written) and its
    indices, never the whole destination. Views, metadata and
    allocations move nothing.

A Python loop of 7 products dispatches 7 and counts 7: there are no trip
counts to infer. One card runs no collective, so there are no wire bytes
and no ``top_collectives``; :func:`top_ops` ranks the ops by FLOPs and
by bytes instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops that allocate, alias or read a scalar: no bytes move
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "resize_",
         "_local_scalar_dense"}
# gathers: the slice is read and written, the indices read
_GATHERS = {"index", "gather", "index_select", "embedding",
            "take_along_dim"}
# writes into part of their first argument, by the positions of their
# indices and their values: the values are read and written, the indices
# read; the destination is not read
_PARTIAL_WRITES = {
    **dict.fromkeys(("index_put", "index_put_", "_index_put_impl_"), (1, 2)),
    **dict.fromkeys(("index_add", "index_add_", "index_copy", "index_copy_",
                     "scatter", "scatter_", "scatter_add", "scatter_add_",
                     "scatter_reduce", "scatter_reduce_"), (2, 3))}


@dataclasses.dataclass
class Stats:
    """Totals of one counted run, and ``by_op``: op name → ``{"flops",
    "bytes", "calls"}``."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    by_op: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def add(self, op: str, flops: float, n_bytes: float):
        self.flops += flops
        self.hbm_bytes += n_bytes
        row = self.by_op.setdefault(op, {"flops": 0.0, "bytes": 0.0,
                                         "calls": 0})
        row["flops"] += flops
        row["bytes"] += n_bytes
        row["calls"] += 1


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _dot_flops(name: str, args) -> float:
    """``2 · out_elems · K`` of a matrix product."""
    a, b = args[1:3] if name in ("addmm", "baddbmm") else args[:2]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * b.shape[-1] * a.shape[-1]


def _conv_flops(args, out) -> float:
    """``2 · out_elems · in_channels/groups · prod(kernel window)``;
    ``convolution(input, weight, bias, stride, padding, dilation,
    transposed, output_padding, groups)``."""
    w = args[1]
    transposed = bool(args[6]) if len(args) > 6 else False
    groups = int(args[8]) if len(args) > 8 else 1
    in_per_group = w.shape[0] // groups if transposed else w.shape[1]
    return 2.0 * out.numel() * in_per_group * math.prod(w.shape[2:])


_DOTS = {"mm", "addmm", "bmm", "baddbmm"}


def op_cost(func, args, kwargs, out):
    """``(flops, bytes)`` of one dispatched op (module docstring)."""
    name = func._schema.name.split("::")[-1]
    if name in _FREE or func.is_view:
        return 0.0, 0.0
    flops = 0.0
    if name in _DOTS:
        flops = _dot_flops(name, args)
    elif name == "convolution":
        flops = _conv_flops(args, out)
    if name in _GATHERS:
        idx = [t for t in _tensors((args[1:], kwargs))
               if not t.is_floating_point()]
        return flops, 2.0 * _nbytes(out) + _nbytes(idx)
    if name in _PARTIAL_WRITES:
        i, v = _PARTIAL_WRITES[name]
        vals = args[v] if len(args) > v else kwargs.get("src", ())
        return flops, 2.0 * _nbytes(vals) + _nbytes(args[i])
    if name == "copy_":                     # dst is written, not read
        return flops, float(_nbytes(args[:2]))
    if name in ("zeros", "ones", "full", "zeros_like", "ones_like",
                "full_like", "fill_", "zero_", "arange", "scalar_tensor"):
        return flops, float(_nbytes(out))   # written, nothing read
    if out is None:
        # an in-place op that returns nothing (``_foreach_*_``) writes the
        # arguments it mutates
        out = [a for a, spec in zip(args, func._schema.arguments)
               if spec.alias_info is not None and spec.alias_info.is_write]
    return flops, float(_nbytes((args, kwargs)) + _nbytes(out))


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched while it is active into ``self.stats``
    (autograd's backward, and the recompute of a checkpoint, included)."""

    def __init__(self):
        super().__init__()
        self.stats = Stats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops, n_bytes = op_cost(func, args, kwargs, out)
        if flops or n_bytes:
            self.stats.add(func._schema.name.split("::")[-1], flops,
                           n_bytes)
        return out


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Stats)`` of one run of ``fn``."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.stats


def top_ops(st: Stats, n: int = 12) -> Dict[str, List[dict]]:
    """The ``n`` ops with the most FLOPs and the ``n`` with the most
    bytes (the counterpart of the reference's ``top_collectives``)."""
    rows = [dict(op=k, **v) for k, v in st.by_op.items()]
    return {key: sorted((r for r in rows if r[key]),
                        key=lambda r: -r[key])[:n]
            for key in ("flops", "bytes")}
