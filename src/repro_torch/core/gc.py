"""Garbage collection of old versions (paper §5.3).

The application bounds the maximal transaction execution time ``E``. The
GC thread snapshots the timestamp vector ``T_R`` every interval and keeps
the snapshots with their wall-clock times; an overflow version that is not
the newest one visible at the newest snapshot older than ``E`` can never
be read again, so it gets the deleted bit, and marked versions are
truncated lazily (:func:`repro_torch.core.mvcc.compact_overflow`).
Transactions older than ``E`` may abort with ``snapshot_miss``.

Vectors are uint32 words in int32 storage (``repro_torch._u32``). The
functions that change a log or a table update it **in place** and return
it, as the rest of the port does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch._u32 import to_i32, u64
from repro_torch.core import header as hdr_ops, mvcc
from repro_torch.core.mvcc import VersionedTable


class SnapshotLog(NamedTuple):
    times: torch.Tensor  # int32 [S] — wall-clock (monotone), -1 = unused
    vecs: torch.Tensor   # int32 [S, n_slots] — uint32 words


def init_log(n_snapshots: int, n_slots: int, *, device=None) -> SnapshotLog:
    """An empty log on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return SnapshotLog(
        times=torch.full((n_snapshots,), -1, dtype=torch.int32, device=dev),
        vecs=torch.zeros((n_snapshots, n_slots), dtype=torch.int32,
                         device=dev))


def take_snapshot(log: SnapshotLog, now, vec) -> SnapshotLog:
    """Store ``vec`` (a copy) with its wall-clock time ``now``: in the first
    unused slot (time -1) if one remains, else over the oldest snapshot.
    ``argmax``/``argmin`` take the first index of a tie in torch as in JAX,
    so the slot is the reference's."""
    unused = log.times < 0
    # analysis: safe(W03): boolean unused-mask operand — no sentinels
    first_unused = unused.to(torch.int8).argmax()
    # analysis: safe(W03): where-guarded — picked only when no -1 remains
    oldest = log.times.argmin()
    pos = torch.where(unused.any(), first_unused, oldest)[None]
    log.times.index_fill_(0, pos, int(now))
    log.vecs.index_copy_(0, pos, vec[None].to(torch.int32))
    return log


def safe_vector(log: SnapshotLog, now, max_txn_time) -> torch.Tensor:
    """The elementwise max over the snapshots older than ``E``: no live
    transaction can hold an older read timestamp. A new tensor."""
    old_enough = (log.times >= 0) & (log.times <= now - max_txn_time)
    masked = torch.where(old_enough[:, None], u64(log.vecs), 0)
    return to_i32(masked.max(dim=0).values)


def collect(table: VersionedTable, safe_vec) -> VersionedTable:
    """The GC thread's sweep of the overflow region, in place: per record,
    among the overflow versions visible at ``safe_vec`` only the newest
    survives; older ones get the deleted bit. Versions invisible there
    (newer) are never touched."""
    h = table.ovf_hdr
    vis = hdr_ops.visible(h, safe_vec) & ~hdr_ops.is_deleted(h)   # [R, KO]
    vis_cts = torch.where(vis, u64(hdr_ops.commit_ts(h)), 0)
    newest = vis_cts.max(dim=1, keepdim=True).values
    doomed = vis & (vis_cts < newest)
    meta = h[..., hdr_ops.META]
    meta.copy_(torch.where(doomed, meta | hdr_ops.DELETED_BIT, meta))
    return table


def gc_round(table: VersionedTable, vec, log: SnapshotLog, now,
             max_txn_time):
    """One step of the GC thread (§5.3): snapshot ``T_R`` into the log,
    derive the safe vector, sweep, truncate. Returns ``(table, log)``,
    both updated in place."""
    take_snapshot(log, now, vec)
    safe = safe_vector(log, now, max_txn_time)
    mvcc.compact_overflow(collect(table, safe))
    return table, log


def reclaimable_fraction(table: VersionedTable,
                         n_records: int | None = None) -> torch.Tensor:
    """Telemetry: the share of overflow slots whose deleted bit is set, over
    the first ``n_records`` records when given. The reference's float32
    mean is its float32 sum of 0/1 values (exact below 2^24 slots; the
    50-warehouse pool has 13.5 M) times the float32 reciprocal of the slot
    count, as XLA divides by a constant; the port forms that product from
    the exact count. Both operands are device tensors: a Python number
    there would take another rounding path on the card."""
    hdrs = table.ovf_hdr if n_records is None else table.ovf_hdr[:n_records]
    d = hdr_ops.is_deleted(hdrs)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=d.device)
    return d.sum().to(torch.float32) * (f32(1.0) / f32(float(d.numel())))
