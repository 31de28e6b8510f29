"""Carry TPC-C state between the reference package and the port.

``tpcc_state_from_numpy`` reads a reference ``TPCCState`` whose leaves are
numpy arrays (uint32 lanes as they are, or already viewed as int32) and
builds the port's state on ``device``; ``tpcc_state_to_numpy`` maps the
port's state back to numpy leaves with the reference's dtypes. Both walk
the fields by name, so any object with the reference's attribute layout
will do. This is how both packages start from identical data. The §6.2
journal (``wal.Journal``) and the §5.3 snapshot log (``gc.SnapshotLog``)
cross the same way (``journal_from_numpy``, ``journal_to_numpy``,
``snapshot_log_from_numpy``, ``snapshot_log_to_numpy``), whatever their
leading axes: a journal of one replica a memory server, and the
per-server snapshot logs of ``store.init_shard_logs`` stacked on a
leading shard axis, cross as they are.

The oracle state inside a TPC-C state crosses as whichever of the
oracles' states it is: a ``VectorState``, the naive adapter's
``NaiveAdapterState`` or a bare ``GlobalCounterState``
(``oracle_state_from_numpy``, ``oracle_state_to_numpy``), told apart by
their fields.

``tensor_from_numpy`` and ``tensor_to_numpy`` carry float arrays (the
inputs and outputs of the LM kernels) across, bfloat16 included: JAX's
bfloat16 reaches numpy as an extension dtype named ``bfloat16``, which
``torch.from_numpy`` refuses, so its 16-bit words travel as ``int16`` and
are viewed as ``torch.bfloat16`` on the other side.

``lm_params_from_numpy`` builds the port's ``Transformer`` from the
reference's ``init_params`` tree (numpy leaves, stacked over pattern units
on a leading axis: ``u{p}/attn/wq[u]`` becomes ``layers.{u·unit_len +
p}.attn.wq``; the encoder's layers, stacked over ``encoder_layers``,
become ``encoder.layers.{j}``, and ``cross/attn/wq[i]``, stacked over
every layer, ``cross.{i}.attn.wq``), and ``lm_params_to_numpy`` gives
the tree back (bfloat16 leaves as float32, exactly); leaves the reference
keeps in float32 (norm scales, the router, the recurrent layers' gates
and SSM constants) stay float32. Training crosses in the same layout:
``grads_to_numpy`` (a train step's gradient sums, or each parameter's
``.grad``), ``adamw_state_to_numpy`` and ``adamw_state_from_numpy`` (the
optimizer's ``m`` and ``v``), and, for checkpoints, ``lm_params_to_tree``
and ``adamw_state_to_tree`` (host tensors in their own dtype, whose leaf
paths are the reference's) with ``lm_params_load_tree`` back.
``decode_cache_from_numpy`` and ``decode_cache_to_numpy`` carry a
``DecodeCache`` across the same way:
the reference's slot of each pattern-unit position, its K/V or recurrent
state stacked over units, ↔ the port's one slot a layer; ``enc_kv`` as
it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._u32 import np_to_i32, np_to_u32
from repro_torch.core import gc, hashtable as ht, mvcc, rangeindex as ri, \
    store, wal
from repro_torch.core.tsoracle import GlobalCounterState, \
    NaiveAdapterState, VectorState
from repro_torch.db.tpcc import TPCCState
from repro_torch.models.blocks import LayerCacheSlot
from repro_torch.models.recurrent import MambaCache, MLSTMCache, SLSTMCache
from repro_torch.models.transformer import DecodeCache, Transformer
from repro_torch.train.optimizer import AdamWState

# fields that hold uint32 words in the reference
U32_FIELDS = frozenset({"cur_hdr", "old_hdr", "ovf_hdr", "vec", "keys",
                        "base_keys", "delta_keys", "ts_vec", "new_hdr",
                        "vecs", "cts", "rts", "bitmap", "offset"})


def _t(a, device):
    return torch.from_numpy(np_to_i32(a)).to(device)


def _tuple_from(cls, obj, device):
    return cls(*(_t(getattr(obj, f), device) for f in cls._fields))


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A float (or any numeric) numpy array as a tensor on ``device``;
    a bfloat16 array (detected by its dtype's name) keeps its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        words = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a.copy(order="C")).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 becomes float32 (exactly), since
    numpy has no bfloat16 of its own."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def tpcc_state_from_numpy(tree, device) -> TPCCState:
    nam = tree.nam
    directory = None
    if tree.directory is not None:
        directory = _tuple_from(ht.HashTable, tree.directory, device)
    return TPCCState(
        nam=store.NAMStore(
            table=_tuple_from(mvcc.VersionedTable, nam.table, device),
            oracle_state=oracle_state_from_numpy(nam.oracle_state, device),
            extends=_tuple_from(store.ExtendState, nam.extends, device)),
        order_index=_tuple_from(ri.RangeIndex, tree.order_index, device),
        hist_cursor=_t(tree.hist_cursor, device),
        directory=directory)


def _to_np(tup):
    return type(tup)(*(
        np_to_u32(t.cpu().numpy()) if f in U32_FIELDS else t.cpu().numpy()
        for f, t in zip(tup._fields, tup)))


def tpcc_state_to_numpy(state: TPCCState) -> TPCCState:
    """The port's state with numpy leaves in the reference's dtypes."""
    nam = state.nam
    return TPCCState(
        nam=store.NAMStore(table=_to_np(nam.table),
                           oracle_state=oracle_state_to_numpy(
                               nam.oracle_state),
                           extends=_to_np(nam.extends)),
        order_index=_to_np(state.order_index),
        hist_cursor=state.hist_cursor.cpu().numpy(),
        directory=None if state.directory is None
        else _to_np(state.directory))


def oracle_state_from_numpy(s, device):
    """An oracle's state with numpy (or JAX) leaves as the port's: a
    ``NaiveAdapterState`` when it has a global counter (``gc``), a
    ``GlobalCounterState`` when it has a bitmap, else a ``VectorState``."""
    if hasattr(s, "gc"):
        return NaiveAdapterState(vec=_t(s.vec, device),
                                 gc=_tuple_from(GlobalCounterState, s.gc,
                                                device))
    if hasattr(s, "bitmap"):
        return _tuple_from(GlobalCounterState, s, device)
    return _tuple_from(VectorState, s, device)


def oracle_state_to_numpy(s):
    """The port's oracle state with numpy leaves in the reference's
    dtypes (uint32 words)."""
    if isinstance(s, NaiveAdapterState):
        return NaiveAdapterState(vec=np_to_u32(s.vec.cpu().numpy()),
                                 gc=_to_np(s.gc))
    return _to_np(s)


def journal_from_numpy(j, device) -> wal.Journal:
    return _tuple_from(wal.Journal, j, device)


def journal_to_numpy(j: wal.Journal) -> wal.Journal:
    """The journal with numpy leaves in the reference's dtypes."""
    return _to_np(j)


def snapshot_log_from_numpy(log, device) -> gc.SnapshotLog:
    return _tuple_from(gc.SnapshotLog, log, device)


def snapshot_log_to_numpy(log: gc.SnapshotLog) -> gc.SnapshotLog:
    return _to_np(log)


def _lm_place(name: str, unit_len: int):
    """(path in the reference's tree, index on its stacked axis or None)
    of state-dict key ``name``: ``layers.{i}`` is ``u{i % unit_len}``
    at ``i // unit_len``, ``cross.{i}`` is ``cross`` at ``i`` and
    ``encoder.layers.{j}`` is ``encoder/layers`` at ``j``."""
    parts = name.split(".")
    if parts[0] == "layers":
        i = int(parts[1])
        return [f"u{i % unit_len}"] + parts[2:], i // unit_len
    if parts[0] == "cross":
        return parts[:1] + parts[2:], int(parts[1])
    if parts[:2] == ["encoder", "layers"]:
        return parts[:2] + parts[3:], int(parts[2])
    return parts, None


def _lm_leaf(tree, name: str, unit_len: int):
    """The reference leaf of state-dict key ``name``."""
    path, i = _lm_place(name, unit_len)
    for part in path:
        tree = tree[part]
    leaf = np.asarray(tree)
    return leaf if i is None else leaf[i]


def lm_params_from_numpy(cfg, tree, device="cpu", *,
                         dtype=None) -> Transformer:
    """The reference's LM parameter tree as the port's ``Transformer`` on
    ``device``, in ``dtype`` (by default the tree's embedding's; the norm
    scales and the router stay float32)."""
    dtype = dtype or tensor_from_numpy(np.asarray(tree["embed"])[:1]).dtype
    model = Transformer(cfg, dtype=dtype, device=device)
    ul = cfg.unit_len
    model.load_state_dict({
        name: tensor_from_numpy(_lm_leaf(tree, name, ul), device)
        for name in model.state_dict()})
    return model


def lm_params_to_numpy(model: Transformer) -> dict:
    """The reference's tree of the port's ``Transformer``: numpy leaves
    stacked as the reference stacks them, bfloat16 as float32."""
    return lm_tree(model.state_dict(), model.cfg.unit_len)


def lm_tree(named: dict, unit_len: int, leaf=tensor_to_numpy,
            stack=np.stack) -> dict:
    """The reference's tree of ``named`` (state-dict name → tensor, in
    the layout of a ``Transformer``'s parameters): ``leaf`` of each
    tensor, stacked over units by ``stack``."""
    tree = {}
    for name, t in named.items():
        path, i = _lm_place(name, unit_len)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if i is None:
            node[path[-1]] = leaf(t)
        else:
            node.setdefault(path[-1], {})[i] = leaf(t)
    return _stack_units(tree, stack)


def _stack_units(node, stack=np.stack):
    if not isinstance(node, dict):
        return node
    if all(isinstance(k, int) for k in node):
        return stack([node[u] for u in sorted(node)])
    return {k: _stack_units(v, stack) for k, v in node.items()}


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def lm_params_to_tree(model: Transformer) -> dict:
    """The reference's tree of the model's parameters as host tensors in
    their own dtype (bfloat16 kept): what a training checkpoint saves,
    so that its leaf paths are the reference's."""
    return lm_tree(model.state_dict(), model.cfg.unit_len, _host,
                   torch.stack)


def lm_params_load_tree(model: Transformer, tree) -> Transformer:
    """Copy the reference-layout ``tree`` (numpy or tensor leaves) into
    the model's parameters in place; returns the model."""
    ul = model.cfg.unit_len
    with torch.no_grad():
        for name, p in model.state_dict().items():
            p.copy_(_leaf_tensor(tree, name, ul))
    return model


def _leaf_tensor(tree, name: str, unit_len: int) -> torch.Tensor:
    path, i = _lm_place(name, unit_len)
    for part in path:
        tree = tree[part]
    t = tree if isinstance(tree, torch.Tensor) else tensor_from_numpy(tree)
    return t if i is None else t[i]


def grads_to_numpy(model: Transformer, grads=None) -> dict:
    """Gradients in the reference's stacked tree as float32 numpy leaves:
    ``grads`` (name → tensor, e.g. a train step's float32 sums), or each
    parameter's ``.grad`` (zeros where it has none)."""
    if grads is None:
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
    return lm_tree({n: g.float() for n, g in grads.items()},
                   model.cfg.unit_len)


def adamw_state_to_numpy(model: Transformer, state: AdamWState
                         ) -> AdamWState:
    """An ``AdamWState`` as the reference's: ``step`` a 0-d int32 array,
    ``m`` and ``v`` float32 trees in ``lm_params_to_numpy``'s layout."""
    ul = model.cfg.unit_len
    return AdamWState(step=state.step.cpu().numpy(),
                      m=lm_tree(state.m, ul), v=lm_tree(state.v, ul))


def adamw_state_from_numpy(model: Transformer, state, device="cpu"
                           ) -> AdamWState:
    """The reference's ``AdamWState`` (numpy or JAX leaves, stacked) as
    the port's for ``model``'s parameters, on ``device``."""
    ul = model.cfg.unit_len
    names = [n for n, _ in model.named_parameters()]

    def moments(tree):
        return {n: _leaf_tensor(tree, n, ul).float().to(device)
                .contiguous() for n in names}
    return AdamWState(
        step=torch.as_tensor(np.asarray(state.step), dtype=torch.int32)
        .to(device), m=moments(state.m), v=moments(state.v))


def adamw_state_to_tree(model: Transformer, state: AdamWState
                        ) -> AdamWState:
    """``adamw_state_to_numpy``'s tree of host tensors: what a training
    checkpoint saves."""
    ul = model.cfg.unit_len
    return AdamWState(step=_host(state.step),
                      m=lm_tree(state.m, ul, _host, torch.stack),
                      v=lm_tree(state.v, ul, _host, torch.stack))


# the recurrent state of each LayerCacheSlot field that holds one
_STATES = {"mamba": MambaCache, "mlstm": MLSTMCache, "slstm": SLSTMCache}


def _unused(v):
    """A slot field's ``()`` placeholder."""
    return isinstance(v, tuple) and not v


def decode_cache_from_numpy(cfg, cache, device="cpu") -> DecodeCache:
    """The reference's ``DecodeCache`` with numpy leaves (each unit
    position's slot stacked over units; ``()`` where a slot holds
    nothing) as the port's, one slot a layer in execution order."""
    ul = cfg.unit_len

    def field(v, f, u):
        if _unused(v):
            return ()
        if f in _STATES:
            return _STATES[f](*(tensor_from_numpy(np.asarray(a)[u], device)
                                for a in v))
        return tensor_from_numpy(np.asarray(v)[u], device)

    slots = tuple(LayerCacheSlot(**{
        f: field(getattr(cache.slots[i % ul], f), f, i // ul)
        for f in LayerCacheSlot._fields}) for i in range(cfg.n_layers))
    return DecodeCache(slots=slots,
                       kv_len=tensor_from_numpy(cache.kv_len, device),
                       enc_kv=tuple(tensor_from_numpy(np.asarray(a), device)
                                    for a in cache.enc_kv))


def decode_cache_to_numpy(cfg, cache: DecodeCache) -> DecodeCache:
    """The port's ``DecodeCache`` in the reference's layout: a slot a
    unit position, each leaf stacked over units, numpy leaves (bfloat16
    as float32)."""
    ul = cfg.unit_len

    def stack(vs, f):
        if _unused(vs[0]):
            return ()
        if f in _STATES:
            return _STATES[f](*(np.stack([tensor_to_numpy(getattr(v, g))
                                          for v in vs])
                                for g in _STATES[f]._fields))
        return np.stack([tensor_to_numpy(v) for v in vs])

    slots = tuple(LayerCacheSlot(**{
        f: stack([getattr(s, f) for s in cache.slots[p::ul]], f)
        for f in LayerCacheSlot._fields}) for p in range(ul))
    return DecodeCache(slots=slots, kv_len=tensor_to_numpy(cache.kv_len),
                       enc_kv=tuple(tensor_to_numpy(t)
                                    for t in cache.enc_kv))
