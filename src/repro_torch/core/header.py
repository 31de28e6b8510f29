"""8-byte record headers (paper §5.1, Figure 3), as ``[..., 2]`` int32 words.

Word 0 ("meta") holds the thread id in bits [31:3], moved bit 2, deleted
bit 1 and locked bit 0; word 1 ("cts") holds the 32-bit commit timestamp.
Both are uint32 bit patterns in int32 storage (see ``repro_torch._u32``).
The pair is compared as a unit wherever the paper compares the 8-byte
header, as the RNIC's compare-and-swap does.
"""
from __future__ import annotations

import torch

from repro_torch._u32 import gidx, to_i32, u64

LOCKED_BIT = 1 << 0
DELETED_BIT = 1 << 1
MOVED_BIT = 1 << 2
THREAD_SHIFT = 3   # thread ids are 29 bits wide

META = 0
CTS = 1


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _flag(x, bit, dev):
    return torch.where(torch.as_tensor(x, device=dev), bit, 0)


def pack(thread_id, cts, *, moved=False, deleted=False, locked=False):
    """Build ``[..., 2]`` int32 headers from components (broadcasting)."""
    dev = _device_of(thread_id, cts, moved, deleted, locked)
    meta = u64(torch.as_tensor(thread_id, device=dev)) << THREAD_SHIFT
    meta = (meta | _flag(moved, MOVED_BIT, dev) | _flag(deleted, DELETED_BIT, dev)
            | _flag(locked, LOCKED_BIT, dev))
    cts = to_i32(u64(torch.as_tensor(cts, device=dev)))
    return torch.stack(torch.broadcast_tensors(to_i32(meta), cts), dim=-1)


def thread_id(hdr):
    """The 29-bit thread id, as int64."""
    return u64(hdr[..., META]) >> THREAD_SHIFT


def commit_ts(hdr):
    return hdr[..., CTS]


def key64(hdr):
    """A sortable scalar view of the header, its commit timestamp as an
    unsigned value (int64). It orders the versions of one thread, whose
    timestamps are totally ordered; versions of different threads are
    ordered only by visibility."""
    return u64(hdr[..., CTS])


def is_locked(hdr):
    return (hdr[..., META] & LOCKED_BIT) != 0


def is_deleted(hdr):
    return (hdr[..., META] & DELETED_BIT) != 0


def is_moved(hdr):
    return (hdr[..., META] & MOVED_BIT) != 0


def _with_bit(hdr, bit, on):
    meta = hdr[..., META]
    on = torch.as_tensor(on, device=hdr.device)
    meta = torch.where(on, meta | bit, meta & ~bit)
    return torch.stack(torch.broadcast_tensors(meta, hdr[..., CTS]), dim=-1)


def with_lock(hdr, locked):
    """``hdr`` with the locked bit set or cleared (a new tensor)."""
    return _with_bit(hdr, LOCKED_BIT, locked)


def with_moved(hdr, moved):
    return _with_bit(hdr, MOVED_BIT, moved)


def with_deleted(hdr, deleted):
    return _with_bit(hdr, DELETED_BIT, deleted)


def equal(a, b):
    """Full 8-byte equality — the unit the RNIC CAS compares."""
    return (a == b).all(dim=-1)


def visible(hdr, ts_vector):
    """Paper §4.1: ``⟨i, t⟩`` is visible under ``T_R`` iff ``t <= T_R[i]``.

    The thread id indexes the vector with JAX's clamping gather, i.e.
    ``minimum(tid, n - 1)`` since a shifted word is never negative.
    """
    tsv = ts_vector[gidx(thread_id(hdr), ts_vector.shape[0])]
    return u64(commit_ts(hdr)) <= u64(tsv)
