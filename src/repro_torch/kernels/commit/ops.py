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

import functools

import torch

from repro_torch._u32 import gidx, rows_of
from repro_torch.core.mvcc import VersionedTable
from repro_torch.kernels import _cuda
from repro_torch.kernels.commit.ref import FusedCommitOut, fused_commit_ref

_P, _I, _I64 = _cuda.P, _cuda.I, _cuda.I64
_ARGTYPES = [_P, _P, _P, _P, _I, _I64, _I, _P, _P, _P, _P, _P, _P, _I64,
             _P, _P, _P, _P, _I, *[_P] * 8]


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
    _cuda.check("fused_commit", dev, i32, cur_hdr=table.cur_hdr,
                old_hdr=table.old_hdr, next_write=table.next_write, vec=vec,
                req_slots=req_slots, req_expected=req_expected,
                req_prio=req_prio, txn_of_req=txn_of_req, new_hdr=new_hdr,
                txn_slot=txn_slot, cts=cts, ext_fails=ext_fails)
    _cuda.check("fused_commit", dev, b, req_active=req_active, txn_ok=txn_ok)
    R, Q, T = table.n_records, req_slots.shape[0], txn_ok.shape[0]
    empty = lambda *s, dtype=i32: torch.empty(s, dtype=dtype, device=dev)
    # scratch: arb is reset per touched slot by the kernel itself
    scratch = (empty(R), empty(Q, 2), empty(Q), empty(Q, dtype=b))
    out = (empty(Q, dtype=b), empty(T, dtype=b), empty(Q, dtype=b),
           empty(T))
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
    if max(Q, T) == 0:   # no kernel to launch, nothing counted
        return lambda: out
    return functools.partial(
        _cuda.launch, _COUNTER, _cuda.entry("fused_commit", _ARGTYPES),
        args, dev, held, out)


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
_COUNTER = fused_commit
