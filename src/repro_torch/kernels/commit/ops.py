"""Wrapper of the CUDA fused-commit kernel (``csrc/fused_commit.cu``).

For tensors on the CPU :func:`fused_commit` runs the plain version
(:mod:`.ref`); for CUDA tensors it launches the kernel or raises — it
never falls back. Every kernel launch adds one to
``fused_commit.launches``. :func:`prepare` validates the inputs and
allocates the outputs and scratch once and returns the launch, which
updates the header planes, ``next_write`` and ``vec`` but not the
payloads.

Both :func:`fused_commit` and its plain version update the table (header
planes, ``next_write``, payloads) and ``vec`` **in place** and return them
inside :class:`FusedCommitOut`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._u32 import gidx, rows_of
from repro_torch.core.mvcc import VersionedTable
from repro_torch.kernels import _build
from repro_torch.kernels.commit.ref import FusedCommitOut, fused_commit_ref

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
             _P, _P, _P, _P, _P, _P, ctypes.c_int64, _P, _P, _P, _P,
             ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P]


def _lib():
    fn = _build.load("fused_commit").fused_commit_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _launch(fn, args, n, held, out, dev):
    """Launch on the current stream; ``held`` keeps the buffers alive.
    With no requests and no transactions there is no kernel to launch, and
    nothing is counted."""
    if n == 0:
        return out
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_commit kernel launch failed: CUDA error "
                           f"{err}")
    _COUNTER.launches += 1
    return out


def prepare(table: VersionedTable, vec, req_slots, req_expected, req_prio,
            req_active, txn_of_req, new_hdr, txn_ok, txn_slot, cts,
            ext_fails):
    """Validate CUDA inputs, allocate outputs and scratch; returns a
    function that launches the kernel and returns ``(granted, committed,
    do_install, fails)``."""
    dev = table.cur_hdr.device
    if dev.type != "cuda":
        raise ValueError(f"fused_commit: no kernel for device {dev}")
    i32, b = torch.int32, torch.bool
    for name, t, dt in (
            ("cur_hdr", table.cur_hdr, i32), ("old_hdr", table.old_hdr, i32),
            ("next_write", table.next_write, i32), ("vec", vec, i32),
            ("req_slots", req_slots, i32), ("req_expected", req_expected, i32),
            ("req_prio", req_prio, i32), ("req_active", req_active, b),
            ("txn_of_req", txn_of_req, i32), ("new_hdr", new_hdr, i32),
            ("txn_ok", txn_ok, b), ("txn_slot", txn_slot, i32),
            ("cts", cts, i32), ("ext_fails", ext_fails, i32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"fused_commit: {name} must be a contiguous {dt} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    R, Q, T = table.n_records, req_slots.shape[0], txn_ok.shape[0]
    empty = lambda *s, dtype=i32: torch.empty(s, dtype=dtype, device=dev)
    # scratch: arb is reset per touched slot by the kernel itself
    scratch = (empty(R), empty(Q, 2), empty(Q), empty(Q, dtype=b))
    out = (empty(Q, dtype=b), empty(T, dtype=b), empty(Q, dtype=b),
           empty(T))
    fn = _lib()
    args = (table.cur_hdr.data_ptr(), table.old_hdr.data_ptr(),
            table.next_write.data_ptr(), vec.data_ptr(), vec.shape[0], R,
            table.n_old, req_slots.data_ptr(), req_expected.data_ptr(),
            req_prio.data_ptr(), req_active.data_ptr(), txn_of_req.data_ptr(),
            new_hdr.data_ptr(), Q, txn_ok.data_ptr(), txn_slot.data_ptr(),
            cts.data_ptr(), ext_fails.data_ptr(), T,
            *(t.data_ptr() for t in scratch), *(t.data_ptr() for t in out))

    # the launch holds every tensor it points at: a buffer known only by
    # its address could be freed and handed to another tensor meanwhile
    held = (table, vec, req_slots, req_expected, req_prio, req_active,
            txn_of_req, new_hdr, txn_ok, txn_slot, cts, ext_fails, scratch)
    return functools.partial(_launch, fn, args, max(Q, T), held, out, dev)


def fused_commit(table: VersionedTable, vec, req_slots, req_expected,
                 req_prio, req_active, txn_of_req, new_hdr, new_data,
                 txn_ok, txn_slot, cts, ext_fails) -> FusedCommitOut:
    """One round's write side over a flat request array (``Q = T*WS``):
    arguments mirror ``si.commit_write_sets`` (``req_expected``/``new_hdr``
    are int32 [Q, 2] headers, ``req_prio`` and ``cts`` uint32 words) plus
    the make-visible inputs ``vec``, ``txn_slot``, ``cts`` and the remote
    failure counts ``ext_fails`` (zeros on one memory server)."""
    if table.cur_hdr.device.type == "cpu":
        return fused_commit_ref(table, vec, req_slots, req_expected,
                                req_prio, req_active, txn_of_req, new_hdr,
                                new_data, txn_ok, txn_slot, cts, ext_fails)
    launch = prepare(table, vec, req_slots, req_expected, req_prio,
                     req_active, txn_of_req, new_hdr, txn_ok, txn_slot, cts,
                     ext_fails)
    # the payload scatters need the ring position and the current payload
    # as they were BEFORE the launch moves next_write and the headers
    safe = gidx(torch.where(req_active, req_slots, 0), table.n_records)
    wpos = torch.remainder(table.next_write[safe].to(torch.int64),
                           table.n_old)
    prev_data = table.cur_data[safe]
    granted, committed, do_install, fails = launch()

    # payloads, outside the kernel, on its install mask (mvcc.install's
    # payload path: old current → ring victim, new payload → current)
    rows = rows_of(do_install)
    s = safe[rows]
    table.old_data[s, wpos[rows]] = prev_data[rows]
    table.cur_data[s] = new_data[rows]
    return FusedCommitOut(table=table, vec=vec, granted=granted,
                          committed=committed, do_install=do_install,
                          fails=fails)


fused_commit.launches = 0
_COUNTER = fused_commit   # the count lives on the public wrapper
