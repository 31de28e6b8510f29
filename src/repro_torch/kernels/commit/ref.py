"""Plain PyTorch version of the fused commit: the production commit body
``si.commit_write_sets`` followed by the vector oracle's make-visible
scatter-max — exactly what ``si.run_round`` runs when ``fused_commit`` is
off. Its decide-only mode is ``si.decide_write_sets``, which writes
nothing."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._u32 import sidx, to_i32, u64
from repro_torch.core import si
from repro_torch.core.mvcc import VersionedTable


class FusedCommitOut(NamedTuple):
    """Post-commit state and outcome masks. ``release_mask`` is not
    materialized: it is ``granted & ~committed[txn_of_req]``. A
    decide-only call decides nothing: ``granted``, ``committed`` and
    ``do_install`` are None and ``fails`` is its only result."""
    table: VersionedTable
    vec: torch.Tensor         # int32 [n_slots] (uint32 words)
    granted: torch.Tensor     # bool  [Q]
    committed: torch.Tensor   # bool  [T]
    do_install: torch.Tensor  # bool  [Q]
    fails: torch.Tensor       # int32 [T]


def make_visible(vec, txn_slot, cts, committed):
    """``vec[txn_slot] = max(vec[txn_slot], committed ? cts : 0)`` in place;
    an index out of range once negatives wrap is dropped."""
    n = vec.shape[0]
    wide = torch.cat([u64(vec), vec.new_zeros((1,), dtype=torch.int64)])
    wide.scatter_reduce_(0, sidx(txn_slot, n),    # n is a sink
                         torch.where(committed, u64(cts), 0), "amax")
    vec.copy_(to_i32(wide[:n]))
    return vec


def fused_commit_ref(table: VersionedTable, vec, req_slots, req_expected,
                     req_prio, req_active, txn_of_req, new_hdr, new_data,
                     txn_ok, txn_slot, cts, ext_fails, *,
                     decide_only: bool = False) -> FusedCommitOut:
    """Same signature and contract as ``ops.fused_commit``: ``table`` and
    ``vec`` are updated in place and returned in the result; with
    ``decide_only`` neither is written."""
    if decide_only:
        fails = si.decide_write_sets(table, req_slots, req_expected,
                                     req_prio, req_active, txn_of_req,
                                     txn_ok.shape[0])
        return FusedCommitOut(table=table, vec=vec, granted=None,
                              committed=None, do_install=None, fails=fails)
    co = si.commit_write_sets(table, req_slots, req_expected, req_prio,
                              req_active, txn_of_req, new_hdr, new_data,
                              txn_ok, ext_fails=ext_fails)
    make_visible(vec, txn_slot, cts, co.committed)
    return FusedCommitOut(table=co.table, vec=vec, granted=co.granted,
                          committed=co.committed, do_install=co.do_install,
                          fails=co.fails)
