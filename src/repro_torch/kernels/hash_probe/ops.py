"""Wrapper of the CUDA batched-probe kernel (``csrc/batched_probe.cu``).

For tensors on the CPU :func:`batched_probe` runs the plain version
(:mod:`.ref`); for CUDA tensors it launches the kernel or raises — it
never falls back. Every kernel launch adds one to
``batched_probe.launches``. :func:`prepare` validates the inputs and
allocates the outputs once and returns the launch, so a caller can repeat
it on the same buffers.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.mvcc import VersionedTable
from repro_torch.kernels import _build
from repro_torch.kernels.hash_probe.ref import batched_probe_ref

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, ctypes.c_int64, ctypes.c_int, _P, _P, _P, _P, _P, _P,
             ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P, _P,
             _P, ctypes.c_int64, _P, _P, _P, _P, _P]


def _lib():
    fn = _build.load("batched_probe").batched_probe_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(name, t, dtype, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"batched_probe: {name} must be a contiguous {dtype} "
                         f"tensor on {device}, got {t.dtype} on {t.device}")


def _launch(fn, args, held, out, dev):
    """Launch on the current stream; ``held`` keeps the buffers alive."""
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"batched_probe kernel launch failed: CUDA error "
                           f"{err}")
    _COUNTER.launches += 1
    return out


def prepare(dir_keys, dir_vals, table: VersionedTable, ts_vec,
            fallback_slots, keys, key_mask, *, max_probes: int = 16):
    """Validate CUDA inputs and allocate the outputs; returns a function
    that launches the kernel into them and returns ``(slot, found, src,
    pos)``."""
    dev = table.cur_hdr.device
    if dev.type != "cuda":
        raise ValueError(f"batched_probe: no kernel for device {dev}")
    i32 = torch.int32
    for name, t in (("cur_hdr", table.cur_hdr), ("old_hdr", table.old_hdr),
                    ("next_write", table.next_write),
                    ("ovf_hdr", table.ovf_hdr), ("ovf_next", table.ovf_next),
                    ("ts_vec", ts_vec), ("fallback_slots", fallback_slots)):
        _check(name, t, i32, dev)
    if dir_keys is None:
        n_buckets = 0
        dir_keys = dir_vals = keys = key_mask = fallback_slots  # never read
    else:
        n_buckets = dir_keys.shape[0]
        _check("dir_keys", dir_keys, i32, dev)
        _check("dir_vals", dir_vals, i32, dev)
        _check("keys", keys, i32, dev)
        _check("key_mask", key_mask, torch.bool, dev)
    Q = fallback_slots.shape[0]
    out = (torch.empty((Q,), dtype=i32, device=dev),
           torch.empty((Q,), dtype=torch.bool, device=dev),
           torch.empty((Q,), dtype=i32, device=dev),
           torch.empty((Q,), dtype=i32, device=dev))
    fn = _lib()
    args = (dir_keys.data_ptr(), dir_vals.data_ptr(), n_buckets, max_probes,
            table.cur_hdr.data_ptr(), table.old_hdr.data_ptr(),
            table.next_write.data_ptr(), table.ovf_hdr.data_ptr(),
            table.ovf_next.data_ptr(), ts_vec.data_ptr(), ts_vec.shape[0],
            table.cur_hdr.shape[0], table.n_old, table.ovf_hdr.shape[1],
            fallback_slots.data_ptr(), keys.data_ptr(), key_mask.data_ptr(),
            Q, *(o.data_ptr() for o in out))

    # the launch holds every tensor it points at: a buffer known only by
    # its address could be freed and handed to another tensor meanwhile
    held = (dir_keys, dir_vals, table, ts_vec, fallback_slots, keys,
            key_mask)
    return functools.partial(_launch, fn, args, held, out, dev)


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


batched_probe.launches = 0
_COUNTER = batched_probe   # the count lives on the public wrapper
