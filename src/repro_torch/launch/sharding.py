"""Partition rules (``repro/launch/sharding.py``): which mesh axes each
parameter, batch, cache and optimizer leaf would be split over, per shape
kind.

The baseline policy, as the reference's:

* **weights** — 2-D sharded: the "feature" dim over ``model`` and the
  other large dim over ``data``; weights replicate across ``pod``.
* **train/prefill activations** — batch over (pod, data).
* **decode KV caches** — batch over (pod, data), cache *sequence* over
  ``model``.
* **long_500k** — batch = 1: KV sequence over ("data", "model") jointly;
  recurrent state feature dims over ``model``.

A spec is a :class:`P`: one entry a dimension, an axis name, a tuple of
names or None (the reference's ``PartitionSpec``). Rules match the
reference's key strings (``['u0']['attn']['wq']``, ``.slots[0].k``) over
the reference's tree layout: :func:`param_tree` and :func:`cache_tree`
give the port's parameters and ``DecodeCache`` in that layout as
:class:`Shape` leaves (a meta tensor's shape and dtype; nothing is read).

The reference's ``to_shardings`` makes ``NamedSharding`` objects that
place each shard on a device of the mesh; one card holds every shard, so
it has no analogue here. What a chip of a mesh would hold is
:func:`per_device_bytes`, the dry run's counterpart of
``compiled.memory_analysis()``'s argument bytes.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch

from repro_torch import _tree, policy
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.convert import lm_tree
from repro_torch.models.blocks import LayerCacheSlot
from repro_torch.models.transformer import DecodeCache
from repro_torch.train.optimizer import AdamWState


@dataclasses.dataclass(frozen=True, init=False)
class P:
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"))``."""
    dims: tuple

    def __init__(self, *dims):
        object.__setattr__(self, "dims", tuple(dims))

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)


@dataclasses.dataclass(frozen=True)
class Shape:
    """A leaf's shape and dtype."""
    shape: tuple
    dtype: torch.dtype


def shape_of(t) -> Shape:
    return Shape(tuple(t.shape), t.dtype)


def stack_shapes(leaves) -> Shape:
    """The :class:`Shape` of ``leaves`` stacked on a new leading axis."""
    return Shape((len(leaves),) + leaves[0].shape, leaves[0].dtype)


def param_tree(params) -> dict:
    """The reference's parameter tree of ``params`` (a ``Transformer``,
    meta or not) with :class:`Shape` leaves, stacked over units."""
    return lm_tree(params.state_dict(), params.cfg.unit_len, shape_of,
                   stack_shapes)


def cache_tree(cfg: ArchConfig, cache: DecodeCache) -> DecodeCache:
    """The reference's ``DecodeCache`` layout of the port's ``cache`` (one
    slot a layer): a slot a unit position, each leaf stacked over units,
    :class:`Shape` leaves."""
    ul = cfg.unit_len

    def stack(vs):
        if isinstance(vs[0], tuple) and not vs[0]:
            return ()
        if hasattr(vs[0], "_fields"):
            return type(vs[0])(*(stack([getattr(v, f) for v in vs])
                                 for f in vs[0]._fields))
        return stack_shapes([shape_of(v) for v in vs])

    slots = tuple(LayerCacheSlot(*(
        stack([getattr(s, f) for s in cache.slots[p::ul]])
        for f in LayerCacheSlot._fields)) for p in range(ul))
    return DecodeCache(slots=slots, kv_len=shape_of(cache.kv_len),
                       enc_kv=tuple(shape_of(t) for t in cache.enc_kv))


# (regex on the key string, spec WITHOUT the stacked-unit axis)
_PARAM_RULES = [
    (r"\['embed'\]$", P("model", "data")),          # [V, D] vocab→model
    (r"\['(final_ln|ln1|ln2|ln)'\]$", P()),
    (r"\['attn'\]\['wq'\]$", P("data", "model")),
    (r"\['attn'\]\['wk'\]$", P("data", "model")),
    (r"\['attn'\]\['wv'\]$", P("data", "model")),
    (r"\['attn'\]\['wo'\]$", P("model", "data")),
    (r"\['mlp'\]\['w_(in|gate)'\]$", P("data", "model")),
    (r"\['mlp'\]\['w_out'\]$", P("model", "data")),
    (r"\['moe'\]\['router'\]$", P("data", None)),
    (r"\['moe'\]\['w_(in|gate)'\]$", P(None, "data", "model")),
    (r"\['moe'\]\['w_out'\]$", P(None, "model", "data")),
    (r"\['mamba'\]\['in_proj'\]$", P("data", "model")),
    (r"\['mamba'\]\['conv_w'\]$", P(None, "model")),
    (r"\['mamba'\]\['x_proj'\]$", P("model", None)),
    (r"\['mamba'\]\['dt_proj'\]$", P(None, "model")),
    (r"\['mamba'\]\['dt_bias'\]$", P("model")),
    (r"\['mamba'\]\['A_log'\]$", P("model", None)),
    (r"\['mamba'\]\['D_skip'\]$", P("model")),
    (r"\['mamba'\]\['out_proj'\]$", P("model", "data")),
    (r"\['mlstm'\]\['(wq|wk|wv|w_o)'\]$", P("data", "model")),
    (r"\['mlstm'\]\['out'\]$", P("model", "data")),
    (r"\['mlstm'\]\['w_if'\]$", P("data", None)),
    (r"\['slstm'\]\['w_in'\]$", P("data", "model")),
    (r"\['slstm'\]\['r'\]$", P(None, None, None)),
    (r"\['slstm'\]\['bias'\]$", P(None)),
    (r"\['slstm'\]\['out'\]$", P("data", "model")),
    (r"\['cross'\].*\['w(q|k|v)'\]$", P("data", "model")),
    (r"\['cross'\].*\['wo'\]$", P("model", "data")),
    (r"\['encoder'\].*\['w(q|k|v)'\]$", P("data", "model")),
    (r"\['encoder'\].*\['wo'\]$", P("model", "data")),
    (r"\['encoder'\].*\['w_(in|gate)'\]$", P("data", "model")),
    (r"\['encoder'\].*\['w_out'\]$", P("model", "data")),
]


def _spec_for_path(path: str, ndim: int, stacked: bool) -> P:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            dims = list(spec)
            if stacked:
                dims = [None] + dims
            # pad/trim to rank (scalars / extra dims replicate)
            dims = (dims + [None] * ndim)[:ndim]
            return P(*dims)
    return P(*([None] * ndim))


def _divisible(shape, spec: P, mesh) -> P:
    """Drop axis assignments that don't divide the dimension (e.g. 8 kv
    heads on a 16-way model axis) — replicate that dim instead."""
    dims = []
    for size, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                        - len(spec))):
        dims.append(None if ax is None or size % mesh.size_of(ax)
                    else ax)
    return P(*dims)


def param_pspecs(params_tree, mesh) -> Any:
    """The spec tree of a parameter tree in the reference's layout
    (:func:`param_tree`; any leaves with a ``shape``)."""
    specs = []
    for key, leaf in _tree.items(params_tree):
        stacked = bool(re.match(r"\['(u\d+|cross)'\]", key)) \
            and not key.endswith("['embed']")
        # the encoder's layers are stacked too
        if re.match(r"\['encoder'\]\['layers'\]", key):
            stacked = True
        if key.endswith("['embed']") \
                and policy.current().embed_lookup_model_sharded:
            # [V, D] with D→model, so the token gather is local
            spec = P(None, "model")
        else:
            spec = _spec_for_path(key, len(leaf.shape), stacked)
        specs.append(_divisible(leaf.shape, spec, mesh))
    return _tree.rebuild(params_tree, iter(specs))


def batch_pspecs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    dp = ("pod", "data") if "pod" in mesh.axis_names else "data"
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": P(dp, None)}
        if shape.kind == "train":
            specs["targets"] = P(dp, None)
            specs["mask"] = P(dp, None)
        if cfg.is_encdec:
            specs["frames"] = P(dp, None, None)
        if cfg.is_prefix_lm:
            specs["patches"] = P(dp, None, None)
        return specs
    # decode shapes: one token per sequence
    if shape.global_batch == 1:
        return {"token": P(None)}
    return {"token": P(dp)}


def cache_pspecs(cfg: ArchConfig, cache_struct, shape: ShapeConfig, mesh):
    """The spec tree of a cache in the reference's layout
    (:func:`cache_tree`)."""
    dp = ("pod", "data") if "pod" in mesh.axis_names else "data"
    long = shape.global_batch == 1
    bspec = None if long else dp
    seq_axes = ("data", "model") if long else "model"

    def leaf_spec(key, leaf):
        s = leaf.shape
        if re.search(r"\.slots\[\d+\]\.(k|v)$", key):
            # [n_units, B, S, Hkv, Dh] — sequence-sharded attention cache
            return _divisible(s, P(None, bspec, seq_axes, None, None), mesh)
        if ".mamba.conv" in key:        # [n_units, B, dc-1, Di]
            return _divisible(s, P(None, bspec, None, "model"), mesh)
        if ".mamba.ssm" in key:         # [n_units, B, Di, N]
            return _divisible(s, P(None, bspec, "model", None), mesh)
        if ".mlstm.C" in key:           # [n_units, B, H, Dh, Dh]
            return _divisible(s, P(None, bspec, None, "model", None), mesh)
        if ".mlstm.n" in key:
            return _divisible(s, P(None, bspec, None, "model"), mesh)
        if ".mlstm.m" in key:
            return _divisible(s, P(None, bspec, None), mesh)
        if ".slstm." in key:            # [n_units, B, D]
            return _divisible(s, P(None, bspec, "model"), mesh)
        if ".kv_len" in key:
            return _divisible(s, P(bspec), mesh)
        if ".enc_kv" in key:            # [B, Se, D]
            return _divisible(s, P(bspec, None, None), mesh)
        return P(*([None] * len(s)))

    return _tree.rebuild(cache_struct, iter(
        [leaf_spec(k, leaf) for k, leaf in _tree.items(cache_struct)]))


def opt_pspecs(param_specs) -> AdamWState:
    """AdamW's moments take their parameters' specs; the step count
    replicates."""
    return AdamWState(step=P(), m=param_specs, v=param_specs)


def shard_shape(shape, spec: P, mesh) -> tuple:
    """The shape of one chip's shard of a leaf of ``shape`` under
    ``spec``."""
    dims = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-size // (1 if ax is None else mesh.size_of(ax)))
                 for size, ax in zip(shape, dims))


def per_device_bytes(tree, specs, mesh) -> int:
    """The bytes one chip of ``mesh`` holds of ``tree`` (leaves with a
    ``shape`` and a ``dtype``: tensors, meta or not, or :class:`Shape`)
    under the matching spec tree ``specs``."""
    return sum(math.prod(shard_shape(leaf.shape, spec, mesh))
               * leaf.dtype.itemsize
               for leaf, spec in zip(_tree.leaves(tree), _tree.leaves(specs)))
