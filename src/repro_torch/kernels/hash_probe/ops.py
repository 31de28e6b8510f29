"""Wrappers of the CUDA probe kernels (``csrc/batched_probe.cu``,
``csrc/hash_probe.cu``).

For tensors on the CPU :func:`batched_probe` and :func:`hash_probe` run
their plain versions (:mod:`.ref`); for CUDA tensors they launch the kernel
or raise — they never fall back. Every kernel launch adds one to the
wrapper's ``launches``. :func:`prepare` and :func:`prepare_hash_probe`
validate the inputs and allocate the outputs once and return the launch,
so a caller can repeat it on the same buffers.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.mvcc import VersionedTable
from repro_torch.kernels import _cuda
from repro_torch.kernels.hash_probe.ref import batched_probe_ref, \
    hash_probe_ref

_P, _I, _I64 = _cuda.P, _cuda.I, _cuda.I64
THREADS = 256   # a block of either kernel (probe_common.cuh kThreads)
# the header planes and the timestamp vector, as both launches take them
_TABLE_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I64, _I, _I]
_ARGTYPES = {
    "batched_probe": [_P, _P, _I64, _I, *_TABLE_ARGTYPES, _P, _P, _P, _I64,
                      _P, _P, _P, _P],
    "hash_probe": [_P, _P, _I64, _I, *_TABLE_ARGTYPES, _P, _I64, _P, _P, _P,
                   _P],
}


def _check_table(table: VersionedTable, ts_vec):
    """The device of the table; raises unless every plane the kernels read
    is a contiguous int32 CUDA tensor there."""
    dev = table.cur_hdr.device
    if dev.type != "cuda":
        raise ValueError(f"probe: no kernel for device {dev}")
    _cuda.check("probe", dev, torch.int32, cur_hdr=table.cur_hdr,
                old_hdr=table.old_hdr, next_write=table.next_write,
                ovf_hdr=table.ovf_hdr, ovf_next=table.ovf_next, ts_vec=ts_vec)
    return dev


def _table_args(table: VersionedTable, ts_vec):
    return (table.cur_hdr.data_ptr(), table.old_hdr.data_ptr(),
            table.next_write.data_ptr(), table.ovf_hdr.data_ptr(),
            table.ovf_next.data_ptr(), ts_vec.data_ptr(), ts_vec.shape[0],
            table.cur_hdr.shape[0], table.n_old, table.ovf_hdr.shape[1])


def _outputs(Q, dev):
    """``(slot, found, src, pos)`` buffers of ``Q`` lanes."""
    return (torch.empty((Q,), dtype=torch.int32, device=dev),
            torch.empty((Q,), dtype=torch.bool, device=dev),
            torch.empty((Q,), dtype=torch.int32, device=dev),
            torch.empty((Q,), dtype=torch.int32, device=dev))


def _launcher(name, args, n_q, held, out, dev):
    """The launch of kernel ``name``; ``held`` keeps the buffers alive.
    With no lanes there is no kernel to launch, and nothing is counted."""
    if n_q == 0:
        return lambda: out
    return functools.partial(
        _cuda.launch, _COUNTERS[name], _cuda.entry(name, _ARGTYPES[name]),
        args, dev, held, out, launch_points(name))


def launch_points(name):
    """The ``(function, threads, dynamic shared bytes)`` kernel ``name``
    launches."""
    return ((f"{name}_kernel", THREADS, 0),)


def prepare(dir_keys, dir_vals, table: VersionedTable, ts_vec,
            fallback_slots, keys, key_mask, *, max_probes: int = 16):
    """Validate CUDA inputs of :func:`batched_probe` and allocate the
    outputs; returns a function that launches the kernel into them and
    returns ``(slot, found, src, pos)``."""
    dev = _check_table(table, ts_vec)
    _cuda.check("probe", dev, torch.int32, fallback_slots=fallback_slots)
    if dir_keys is None:
        n_buckets = 0
        dir_keys = dir_vals = keys = key_mask = fallback_slots  # never read
    else:
        n_buckets = dir_keys.shape[0]
        _cuda.check("probe", dev, torch.int32, dir_keys=dir_keys,
                    dir_vals=dir_vals, keys=keys)
        _cuda.check("probe", dev, torch.bool, key_mask=key_mask)
    Q = fallback_slots.shape[0]
    out = _outputs(Q, dev)
    args = (dir_keys.data_ptr(), dir_vals.data_ptr(), n_buckets, max_probes,
            *_table_args(table, ts_vec), fallback_slots.data_ptr(),
            keys.data_ptr(), key_mask.data_ptr(), Q,
            *(o.data_ptr() for o in out))
    # the launch holds every tensor it points at: a buffer known only by
    # its address could be freed and handed to another tensor meanwhile
    held = (dir_keys, dir_vals, table, ts_vec, fallback_slots, keys,
            key_mask)
    return _launcher("batched_probe", args, Q, held, out, dev)


def batched_probe(dir_keys, dir_vals, table: VersionedTable, ts_vec,
                  fallback_slots, keys, key_mask, *, max_probes: int = 16):
    """Resolve a whole read-set in one launch: keyed lanes (``key_mask``)
    probe the directory, slot lanes use ``fallback_slots``, and every lane
    locates its newest usable version. ``dir_keys=None`` is the
    locate-only mode. Returns ``(slot, found, src, pos)`` as
    :func:`.ref.batched_probe_ref` does; reads only."""
    if table.cur_hdr.device.type == "cpu":
        return batched_probe_ref(dir_keys, dir_vals, table, ts_vec,
                                 fallback_slots, keys, key_mask,
                                 max_probes=max_probes)
    return prepare(dir_keys, dir_vals, table, ts_vec, fallback_slots, keys,
                   key_mask, max_probes=max_probes)()


def prepare_hash_probe(dir_keys, dir_vals, table: VersionedTable, ts_vec,
                       queries, *, max_probes: int = 16):
    """Validate CUDA inputs of :func:`hash_probe` and allocate the outputs;
    returns a function that launches the kernel into them and returns
    ``(slot, found, src, pos)``."""
    dev = _check_table(table, ts_vec)
    _cuda.check("probe", dev, torch.int32, dir_keys=dir_keys,
                dir_vals=dir_vals, queries=queries)
    if dir_keys.shape[0] == 0:
        raise ValueError("hash_probe: the directory needs at least one "
                         "bucket")
    Q = queries.shape[0]
    out = _outputs(Q, dev)
    args = (dir_keys.data_ptr(), dir_vals.data_ptr(), dir_keys.shape[0],
            max_probes, *_table_args(table, ts_vec), queries.data_ptr(), Q,
            *(o.data_ptr() for o in out))
    held = (dir_keys, dir_vals, table, ts_vec, queries)
    return _launcher("hash_probe", args, Q, held, out, dev)


def hash_probe(dir_keys, dir_vals, table: VersionedTable, ts_vec, queries,
               *, max_probes: int = 16):
    """Probe the directory for every query key (uint32 words in int32
    storage) and locate the newest usable version of its record. Returns
    ``(slot, found, src, pos)`` as :func:`.ref.hash_probe_ref` does: a
    missing or invalidated key gives slot -1 and src = pos = 0. Gather the
    payload with ``mvcc.gather_version``; reads only."""
    if table.cur_hdr.device.type == "cpu":
        return hash_probe_ref(dir_keys, dir_vals, table, ts_vec, queries,
                              max_probes=max_probes)
    return prepare_hash_probe(dir_keys, dir_vals, table, ts_vec, queries,
                              max_probes=max_probes)()


_cuda.counted(batched_probe)
_cuda.counted(hash_probe)
_COUNTERS = {"batched_probe": batched_probe, "hash_probe": hash_probe}
