"""Batched owner-arbitrated compare-and-swap (validate + lock, §3.1/§5.1).

Within one round every lock request that targets the same record is
arbitrated by a scatter-min tournament over the requesters' priorities; the
winner is granted iff its expected 8-byte header equals the installed one
and the record is unlocked. The CUDA commit kernel
(``repro_torch.kernels.commit``) runs the same tournament with
``atomicMin``.

Both functions update ``hdrs`` in place and return it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._u32 import gidx, rows_of, sidx, to_i32, u64
from repro_torch.core import header as hdr_ops

NO_WINNER = 0xFFFFFFFF


class CasResult(NamedTuple):
    granted: torch.Tensor  # bool [Q] — request won arbitration AND matched
    new_hdr: torch.Tensor  # int32 [R, 2] — ``hdrs``, lock bits applied


def _tournament(hdrs, slots, expected, prio, active):
    """The scatter-min tournament and the CAS test, reading ``hdrs`` only:
    ``(granted, installed headers, scatter index)``."""
    n_rec = hdrs.shape[0]
    # gathers clamp (gidx); the scatters drop an index out of range once
    # negatives wrap: it goes to the sink row n_rec (sidx)
    slots = torch.where(active, slots, 0)
    safe, sink = gidx(slots, n_rec), sidx(slots, n_rec)
    mprio = torch.where(active, u64(prio), NO_WINNER)
    arb = torch.full((n_rec + 1,), NO_WINNER, dtype=torch.int64,
                     device=hdrs.device)
    arb.scatter_reduce_(0, sink, mprio, "amin")
    won = active & (arb[safe] == mprio) & (mprio != NO_WINNER)

    installed = hdrs[safe]
    granted = won & hdr_ops.equal(installed, expected) \
        & ~hdr_ops.is_locked(installed)
    return granted, installed, sink


def grant(hdrs, slots, expected, prio, active):
    """Which requests :func:`arbitrate` would grant, taking no lock:
    bool [Q]; ``hdrs`` is not written."""
    return _tournament(hdrs, slots, expected, prio, active)[0]


def arbitrate(hdrs, slots, expected, prio, active) -> CasResult:
    """One round of CAS requests against ``hdrs`` (int32 [R, 2]).

    ``slots`` int32 [Q], ``expected`` int32 [Q, 2], ``prio`` uint32 words
    [Q] (lower wins), ``active`` bool [Q]. Sets the lock bit of every
    granted slot in place.
    """
    n_rec = hdrs.shape[0]
    granted, installed, sink = _tournament(hdrs, slots, expected, prio,
                                           active)
    # scatter-max of (meta | LOCKED): sets the bit where granted, rewrites
    # the unchanged word elsewhere
    meta = torch.cat([u64(hdrs[:, hdr_ops.META]),
                      sink.new_zeros(1)])
    lock_or = torch.where(granted, hdr_ops.LOCKED_BIT, 0)
    meta.scatter_reduce_(0, sink, u64(installed[:, hdr_ops.META]) | lock_or,
                         "amax")
    hdrs[:, hdr_ops.META] = to_i32(meta[:n_rec])
    return CasResult(granted=granted, new_hdr=hdrs)


def release(hdrs, slots, mask):
    """Clear the lock bits of the masked slots (the abort path) in place;
    a slot out of range once negatives wrap is dropped."""
    s = sidx(slots, hdrs.shape[0])
    rows = rows_of(mask & (s < hdrs.shape[0]))
    s = s[rows]
    hdrs[s, hdr_ops.META] = hdrs[s, hdr_ops.META] & ~hdr_ops.LOCKED_BIT
    return hdrs


def all_granted_per_txn(granted, txn_of_request, n_txn: int, request_active):
    """Fold per-record grants into per-transaction commit decisions (bool
    [n_txn]): a transaction commits iff every active write request it
    issued was granted (Listing 1: ``commit = commit && success[i]``), and
    one with no active request always commits. A transaction id out of
    range once negatives wrap is dropped, as the reference's scatter-add
    drops it."""
    idx = sidx(txn_of_request, n_txn)
    counts = torch.zeros((2, n_txn + 1), dtype=torch.int32,
                         device=granted.device)     # row n_txn is a sink
    counts[0].index_add_(0, idx, (request_active & ~granted).to(torch.int32))
    counts[1].index_add_(0, idx, request_active.to(torch.int32))
    return (counts[0, :n_txn] == 0) | (counts[1, :n_txn] == 0)
