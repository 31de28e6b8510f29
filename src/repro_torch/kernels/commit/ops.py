"""Wrapper of the CUDA fused-commit kernel (``csrc/fused_commit.cu``).

For tensors on the CPU :func:`fused_commit` runs the plain version
(:mod:`.ref`); for CUDA tensors it launches the kernel or raises — it
never falls back. The kernel is one launch of one thread-block cluster
and moves the headers and the payloads itself, so the wrapper only
validates, allocates and launches: it reads nothing back from the device.
Every kernel launch adds one to ``fused_commit.launches``, and a
decide-only one also to ``fused_commit.decide_launches``. :func:`prepare`
validates the inputs and allocates the outputs and scratch once and
returns the launch.

Both :func:`fused_commit` and its plain version update the table (header
planes, ``next_write``, payloads) and ``vec`` **in place** and return them
inside :class:`FusedCommitOut`. With ``decide_only`` they write neither:
the launch runs the bid and grant phases, counts each transaction's failed
requests and resets its bids, and ``fails`` is its one output — a memory
server's part of a cross-server decision (``store.distributed_round``).
"""
from __future__ import annotations

import torch

from repro_torch.core.mvcc import VersionedTable
from repro_torch.kernels import _cuda
from repro_torch.kernels.commit.ref import FusedCommitOut, fused_commit_ref

_P, _I, _I64 = _cuda.P, _cuda.I, _cuda.I64
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I64, _I, _I, *[_P] * 7, _I64,
             *[_P] * 4, _I, _I, *[_P] * 7]
# the kernel: one cluster of BLOCKS blocks, each keeping LANE_BYTES for
# every request of its share (the lane state), padded to 16 bytes
BLOCKS, LANE_BYTES = 8, 25
THREADS = 256   # a block (fused_commit.cu kThreads)
# the kernel's arbitration table ([R, 2] int32: bid and vote per record)
# for each (device, stream, record count). Every launch leaves it as it
# found it (bids -1, votes 0), so it carries nothing from one call to the
# next (``csrc/fused_commit.cu``); one table per stream, since two launches
# running at once must not share one.
_ARBITRATION = {}


def _arbitration(dev, stream, n_records):
    """The arbitration table of ``stream``, filled at its first call."""
    key = (dev, stream.cuda_stream, n_records)
    if key not in _ARBITRATION:
        arb = torch.zeros((n_records, 2), dtype=torch.int32, device=dev)
        arb[:, 0] = -1      # no bid: above every bid
        _ARBITRATION[key] = arb
    return _ARBITRATION[key]


def prepare(table: VersionedTable, vec, req_slots, req_expected, req_prio,
            req_active, txn_of_req, new_hdr, new_data, txn_ok, txn_slot, cts,
            ext_fails, *, decide_only: bool = False):
    """Validate CUDA inputs, allocate outputs and scratch; returns a
    function that launches the kernel and returns ``(granted, committed,
    do_install, fails)`` (with ``decide_only``, ``(None, None, None,
    fails)``)."""
    dev = table.cur_hdr.device
    if dev.type != "cuda":
        raise ValueError(f"fused_commit: no kernel for device {dev}")
    i32, b = torch.int32, torch.bool
    _cuda.check("fused_commit", dev, i32, cur_hdr=table.cur_hdr,
                cur_data=table.cur_data, old_hdr=table.old_hdr,
                old_data=table.old_data, next_write=table.next_write, vec=vec,
                req_slots=req_slots, req_expected=req_expected,
                req_prio=req_prio, txn_of_req=txn_of_req, new_hdr=new_hdr,
                new_data=new_data, txn_slot=txn_slot, cts=cts,
                ext_fails=ext_fails)
    _cuda.check("fused_commit", dev, b, req_active=req_active, txn_ok=txn_ok)
    R, K, W = table.n_records, table.n_old, table.payload_width
    Q, T = req_slots.shape[0], txn_ok.shape[0]
    if new_data.shape != (Q, W):
        raise ValueError(f"fused_commit: new_data must be [{Q}, {W}], got "
                         f"{list(new_data.shape)}")
    empty = lambda *s, dtype=i32: torch.empty(s, dtype=dtype, device=dev)
    # scratch: the payload rows the grant phase reads (an install's)
    kept = None if decide_only else empty(Q, W)
    # the lane state goes to global memory when a block's share of it does
    # not fit in shared memory
    lanes = (empty(BLOCKS * smem_bytes(Q), dtype=torch.uint8)
             if smem_bytes(Q) > _cuda.MAX_SMEM else None)
    out = ((None, None, None, empty(T)) if decide_only else
           (empty(Q, dtype=b), empty(T, dtype=b), empty(Q, dtype=b),
            empty(T)))
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (table.cur_hdr.data_ptr(), table.cur_data.data_ptr(),
            table.old_hdr.data_ptr(), table.old_data.data_ptr(),
            table.next_write.data_ptr(), vec.data_ptr(), vec.shape[0], R, K,
            W, req_slots.data_ptr(), req_expected.data_ptr(),
            req_prio.data_ptr(), req_active.data_ptr(), txn_of_req.data_ptr(),
            new_hdr.data_ptr(), new_data.data_ptr(), Q, txn_ok.data_ptr(),
            txn_slot.data_ptr(), cts.data_ptr(), ext_fails.data_ptr(), T,
            int(decide_only), ptr(kept), ptr(lanes),
            *(ptr(t) for t in out))

    # the launch holds every tensor it points at: a buffer known only by
    # its address could be freed and handed to another tensor meanwhile
    held = (table, vec, req_slots, req_expected, req_prio, req_active,
            txn_of_req, new_hdr, new_data, txn_ok, txn_slot, cts, ext_fails,
            kept, lanes)
    if max(Q, T) == 0:   # no kernel to launch, nothing counted
        return lambda: out
    entry = _cuda.entry("fused_commit", _ARGTYPES)

    def launch():
        arb = _arbitration(dev, torch.cuda.current_stream(dev), R)
        res = _cuda.launch(_COUNTER, entry, (*args, arb.data_ptr()), dev,
                           held, out, launch_points(Q))
        _COUNTER.decide_launches += decide_only
        return res
    return launch


def smem_bytes(n_requests: int) -> int:
    """One block's lane state for ``n_requests``: in its shared memory, or
    its stride of the global scratch beyond ``_cuda.MAX_SMEM``."""
    return -(-(-(-n_requests // BLOCKS) * LANE_BYTES) // 16) * 16


def launch_points(n_requests: int):
    """The ``(function, threads, dynamic shared bytes)`` a launch over
    ``n_requests`` runs: the lane state in shared memory, or none when it
    goes to the global scratch."""
    smem = smem_bytes(n_requests)
    return (("fused_commit_kernel", THREADS,
             smem if smem <= _cuda.MAX_SMEM else 0),)


def fused_commit(table: VersionedTable, vec, req_slots, req_expected,
                 req_prio, req_active, txn_of_req, new_hdr, new_data,
                 txn_ok, txn_slot, cts, ext_fails, *,
                 decide_only: bool = False) -> FusedCommitOut:
    """One round's write side over a flat request array (``Q = T*WS``):
    arguments mirror ``si.commit_write_sets`` (``req_expected``/``new_hdr``
    are int32 [Q, 2] headers, ``req_prio`` and ``cts`` uint32 words) plus
    the make-visible inputs ``vec``, ``txn_slot``, ``cts`` and the remote
    failure counts ``ext_fails`` (zeros on one memory server).
    ``decide_only`` returns this call's failure counts and writes nothing
    else (see the module docstring)."""
    if table.cur_hdr.device.type == "cpu":
        return fused_commit_ref(table, vec, req_slots, req_expected,
                                req_prio, req_active, txn_of_req, new_hdr,
                                new_data, txn_ok, txn_slot, cts, ext_fails,
                                decide_only=decide_only)
    granted, committed, do_install, fails = prepare(
        table, vec, req_slots, req_expected, req_prio, req_active,
        txn_of_req, new_hdr, new_data, txn_ok, txn_slot, cts, ext_fails,
        decide_only=decide_only)()
    return FusedCommitOut(table=table, vec=vec, granted=granted,
                          committed=committed, do_install=do_install,
                          fails=fails)


_cuda.counted(fused_commit)
fused_commit.decide_launches = 0   # the decide-only ones among ``launches``
_COUNTER = fused_commit
