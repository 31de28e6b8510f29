"""Logging, recovery and failure handling (paper §6.2).

Each transaction-execution thread writes a private journal to more than
one memory server **before** it installs its write-set. An entry is
``⟨T, S⟩``: the read timestamp vector and the physical write-set (slots,
headers, payloads, write mask), stamped with the driver round and the
sub-round within it. Two records a transaction: :func:`append_intent`
before install, :func:`append_outcome` after the commit decision; an
intent without an outcome is an undetermined transaction (§3.2), which
replay skips and whose locks the monitor releases.

Recovery restores the last checkpoint and replays the journals' committed
entries in a linear extension of the partial order of their logged T: by
the exact ``sum(T)`` (a ⟨hi, lo⟩ base-2^16 digit pair), then round, then
sub-round, then the entry's flat index (thread-major, then ring position).
The reference sorts with ``jnp.lexsort``, whose order among entries equal
on all four keys is not specified; such entries belong to one sub-round,
whose committed write-sets are disjoint, so the order among them does not
change the table. The version mover runs at round boundaries, as in the
live engine, so the recovered overflow rings are laid out as the
uninterrupted run's.

Each journal is a fixed-capacity ring per thread: position ``used %
capacity`` takes the next entry, and replay trusts only the live window,
the appends since ``since`` (the append counts at the checkpoint); it
raises when the ring wrapped past an unreplayed entry.

The intent depends only on commit-phase inputs, so the kernel path and the
plain path write identical journals. Fields are uint32 words in int32
storage where the reference has uint32 (``ts_vec``, ``new_hdr``). The
appends and :func:`rereplicate` update the journal **in place** (the
appends never wait on the device); :func:`grow_replicas` returns a new
journal.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._u32 import gidx, to_i32, u64
from repro_torch.core import cas, header as hdr_ops, mvcc
from repro_torch.core.mvcc import VersionedTable

# sort keys of entries replay skips (uncommitted, undetermined or outside
# the live window): above every real key, whose lo digit is < 2^16 and hi
# digit <= n_slots * 2^16 < 2^32
_KEY_SENTINEL = 0xFFFFFFFF
_SEQ_SENTINEL = 0x7FFFFFFF
ENTRY_FIELDS = ("ts_vec", "slots", "new_hdr", "new_data", "write_mask",
                "committed", "resolved", "round_no", "seq")


class Journal(NamedTuple):
    """A fixed-capacity ring per thread, replicated ``n_replicas`` times
    along the leading axis (recovery reads any surviving replica)."""
    ts_vec: torch.Tensor      # int32 [Rep, Th, Cap, n_slots] — logged T
    slots: torch.Tensor       # int32 [Rep, Th, Cap, WS]
    new_hdr: torch.Tensor     # int32 [Rep, Th, Cap, WS, 2]
    new_data: torch.Tensor    # int32 [Rep, Th, Cap, WS, W]
    write_mask: torch.Tensor  # bool  [Rep, Th, Cap, WS]
    committed: torch.Tensor   # bool  [Rep, Th, Cap] — outcome record
    resolved: torch.Tensor    # bool  [Rep, Th, Cap] — outcome written
    round_no: torch.Tensor    # int32 [Rep, Th, Cap] — driver round
    seq: torch.Tensor         # int32 [Rep, Th, Cap] — sub-round in round
    used: torch.Tensor        # int32 [Th] — total appends (ring cursor)

    @property
    def capacity(self) -> int:
        return self.ts_vec.shape[2]

    @property
    def n_replicas(self) -> int:
        return self.ts_vec.shape[0]


def init_journal(n_threads: int, capacity: int, n_slots: int, ws: int,
                 width: int, n_replicas: int = 2, *, device=None) -> Journal:
    """An empty journal on ``device`` (default ``cuda``)."""
    if n_slots >= 1 << 16:
        raise ValueError(
            f"journal order key supports < 2^16 timestamp slots, got "
            f"{n_slots} (the (hi, lo) digit sum would overflow)")
    dev = resolve_device(device)
    R, T, C = n_replicas, n_threads, capacity
    z = lambda *s, dtype=torch.int32: torch.zeros(s, dtype=dtype, device=dev)
    return Journal(
        ts_vec=z(R, T, C, n_slots),
        slots=torch.full((R, T, C, ws), -1, dtype=torch.int32, device=dev),
        new_hdr=z(R, T, C, ws, 2), new_data=z(R, T, C, ws, width),
        write_mask=z(R, T, C, ws, dtype=torch.bool),
        committed=z(R, T, C, dtype=torch.bool),
        resolved=z(R, T, C, dtype=torch.bool),
        round_no=z(R, T, C), seq=z(R, T, C), used=z(T))


def _put_entry(field, tid, pos, val):
    """Write one entry value per thread on every replica, in place."""
    Rep = field.shape[0]
    rep = torch.arange(Rep, device=field.device)[:, None]
    field[rep, tid[None, :], pos[None, :]] = \
        val.to(field.dtype).expand((Rep,) + val.shape)


def pad_writes(j: Journal, slots, new_hdr, new_data, write_mask):
    """Pad a write-set narrower than the journal's WS with masked-off
    columns (slot 0, zero header and payload, mask False)."""
    ws = j.slots.shape[3]
    T, w = slots.shape
    if w == ws:
        return slots, new_hdr, new_data, write_mask
    if w > ws:
        raise ValueError(f"write-set width {w} exceeds journal WS {ws}")
    pad = ws - w
    z = lambda *s, dtype=torch.int32: torch.zeros(s, dtype=dtype,
                                                  device=slots.device)
    return (torch.cat([slots.to(torch.int32), z(T, pad)], dim=1),
            torch.cat([new_hdr, z(T, pad, 2)], dim=1),
            torch.cat([new_data, z(T, pad, new_data.shape[-1])], dim=1),
            torch.cat([write_mask, z(T, pad, dtype=torch.bool)], dim=1))


def append_intent(j: Journal, tid, ts_vec, slots, new_hdr, new_data,
                  write_mask, *, round_no=0, seq=0) -> Journal:
    """Log the intent records ⟨T, S⟩ of one sub-round *before* install,
    undetermined (``committed = resolved = False``), stamped ``(round_no,
    seq)``; bumps the ring cursors. ``ts_vec`` is the shared read snapshot
    [n_slots]. Widths must be the journal's: pad a narrower write-set with
    :func:`pad_writes`. In place."""
    tid = torch.as_tensor(tid).to(torch.int64)
    T = tid.shape[0]
    n_slots, ws, width = (j.ts_vec.shape[-1], j.slots.shape[-1],
                          j.new_data.shape[-1])
    if ts_vec.shape[-1] != n_slots:
        raise ValueError(
            f"[A4] append_intent: ts_vec width {ts_vec.shape[-1]} != "
            f"journal's declared n_slots {n_slots} — slice the (padded) "
            f"vector to the journal width before logging")
    got = (slots.shape[-1], new_hdr.shape[-2], new_data.shape[-2],
           write_mask.shape[-1], new_data.shape[-1])
    want = (ws, ws, ws, ws, width)
    if got != want:
        raise ValueError(
            f"[A4] append_intent: write-set widths {got} != journal's "
            f"declared (WS, WS, WS, WS, W) {want} — run the write-set "
            f"through wal.pad_writes first")
    pos = torch.remainder(j.used[tid], j.capacity).to(torch.int64)
    dev = j.used.device
    stamp = lambda v: torch.as_tensor(v, device=dev).to(torch.int32) \
        .expand(T)
    _put_entry(j.ts_vec, tid, pos, ts_vec.expand((T,) + ts_vec.shape))
    _put_entry(j.slots, tid, pos, slots)
    _put_entry(j.new_hdr, tid, pos, new_hdr)
    _put_entry(j.new_data, tid, pos, new_data)
    _put_entry(j.write_mask, tid, pos, write_mask)
    no = torch.zeros((T,), dtype=torch.bool, device=dev)
    _put_entry(j.committed, tid, pos, no)
    _put_entry(j.resolved, tid, pos, no)
    _put_entry(j.round_no, tid, pos, stamp(round_no))
    _put_entry(j.seq, tid, pos, stamp(seq))
    j.used.index_add_(0, tid, torch.ones((T,), dtype=torch.int32, device=dev))
    return j


def append_outcome(j: Journal, tid, committed) -> Journal:
    """Write the outcome record of each thread's latest intent: replay
    applies it iff ``committed``. In place."""
    tid = torch.as_tensor(tid).to(torch.int64)
    pos = torch.remainder(j.used[tid] - 1, j.capacity).to(torch.int64)
    _put_entry(j.committed, tid, pos, committed)
    _put_entry(j.resolved, tid, pos, torch.ones_like(committed,
                                                     dtype=torch.bool))
    return j


def _live_window(j: Journal, since=None) -> torch.Tensor:
    """bool [Th, Cap]: ring positions whose latest entry has an append
    index >= ``since`` (per thread; 0 when omitted); never-written
    positions are excluded."""
    Cap = j.capacity
    u = j.used.to(torch.int64)[:, None]
    p = torch.arange(Cap, device=u.device)[None, :]
    idx = u - 1 - torch.remainder(u - 1 - p, Cap)
    lo = torch.zeros_like(j.used) if since is None else torch.as_tensor(since)
    return (idx >= 0) & (idx >= lo.to(u.device, torch.int64)[:, None])


def _check_window_coverage(j: Journal, since) -> None:
    """Raise when the ring overwrote an entry appended after ``since``:
    replaying the live window would then skip its writes."""
    used = j.used.cpu().numpy().astype(np.int64)
    lo = np.zeros_like(used) if since is None \
        else torch.as_tensor(since).cpu().numpy().astype(np.int64)
    over = used - lo > j.capacity
    if over.any():
        worst = int((used - lo).max())
        raise ValueError(
            f"journal ring overwrote unreplayed entries for threads "
            f"{np.nonzero(over)[0].tolist()}: {worst} appends since the "
            f"checkpoint exceed capacity {j.capacity} — grow the journal "
            f"or checkpoint more often")


def _pick_replica(j: Journal, replica, survivors) -> int:
    """``replica``, or the first surviving one of the bool ``survivors``."""
    if survivors is None:
        return replica
    alive = np.asarray(torch.as_tensor(survivors).cpu().numpy(), bool)
    if not alive.any():
        raise ValueError("no surviving journal replica — unrecoverable")
    # analysis: safe(W03): boolean survivor mask, non-empty checked above
    return int(np.argmax(alive))


def _order_keys(j: Journal, replica: int):
    """The exact ``sum(T)`` of every entry as a ⟨hi, lo⟩ base-2^16 digit
    pair, int64 [Th*Cap] each."""
    ts = u64(j.ts_vec[replica])
    lo16 = (ts & 0xFFFF).sum(dim=-1)
    hi16 = (ts >> 16).sum(dim=-1)
    return (hi16 + (lo16 >> 16)).reshape(-1), (lo16 & 0xFFFF).reshape(-1)


def entry_status(j: Journal, replica: int = 0, *, since=None):
    """``(replayable, undetermined)`` bool [Th, Cap] over the live window:
    committed entries replay installs, and intents whose outcome never
    landed (§3.2)."""
    live = _live_window(j, since)
    return (j.committed[replica] & j.resolved[replica] & live,
            ~j.resolved[replica] & live)


def _replay_order(keys):
    """The permutation sorting by ``keys`` (most significant last), ties
    broken by the flat index: stable sorts from the least significant."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def replay(j: Journal, table: VersionedTable, replica: int = 0,
           survivors=None, *, since=None, reuse_only: bool = False,
           move_versions: bool = True) -> VersionedTable:
    """Rebuild ``table`` (a checkpoint) by replaying the journal, in place.

    ``survivors``: optional bool [Rep], which replicas survived (the first
    is read). ``since``: the per-thread append counts at the checkpoint;
    raises if the ring wrapped past an entry after it. Only committed and
    resolved entries install, ordered by the exact ``sum(T)``, round,
    sub-round and flat index; the version mover runs at every round
    boundary, the trailing one included, in the engine's mode
    (``reuse_only``). Entries sort with the skipped ones last, whose
    installs write nothing, and are not issued.
    """
    replica = _pick_replica(j, replica, survivors)
    _check_window_coverage(j, since)
    Th, Cap = j.ts_vec.shape[1], j.capacity
    hi, lo = _order_keys(j, replica)
    com = entry_status(j, replica, since=since)[0].reshape(-1)
    hi = torch.where(com, hi, _KEY_SENTINEL)
    lo = torch.where(com, lo, _KEY_SENTINEL)
    rno = torch.where(com, j.round_no[replica].reshape(-1).to(torch.int64),
                      _SEQ_SENTINEL)
    sq = torch.where(com, j.seq[replica].reshape(-1).to(torch.int64),
                     _SEQ_SENTINEL)
    order = _replay_order((sq, rno, lo, hi))
    WS, W = j.slots.shape[-1], j.new_data.shape[-1]
    slots = j.slots[replica].reshape(Th * Cap, WS)[order]
    hdrs = j.new_hdr[replica].reshape(Th * Cap, WS, 2)[order]
    data = j.new_data[replica].reshape(Th * Cap, WS, W)[order]
    mask = j.write_mask[replica].reshape(Th * Cap, WS)[order] \
        & com[order][:, None]
    rno = rno[order]
    boundary = torch.cat([rno[:-1] != rno[1:],
                          torch.ones((1,), dtype=torch.bool,
                                     device=rno.device)])
    # one transfer tells the host which entries write and where rounds end
    writes, ends = torch.stack([mask.any(dim=1), boundary]).cpu().tolist()
    for e in range(Th * Cap):
        if writes[e]:
            mvcc.install(table, slots[e], hdrs[e], data[e], mask[e])
        if move_versions and ends[e]:
            mvcc.version_mover(table, reuse_only=reuse_only)
    return table


def replay_vector(j: Journal, vec: torch.Tensor, replica: int = 0,
                  survivors=None, *, since=None) -> torch.Tensor:
    """The timestamp vector at the crash: the per-slot max of the
    checkpoint's ``vec`` and every committed entry's commit timestamp
    (logged in its first header). A new tensor."""
    replica = _pick_replica(j, replica, survivors)
    _check_window_coverage(j, since)
    com = entry_status(j, replica, since=since)[0].reshape(-1)
    h = j.new_hdr[replica][:, :, 0, :]                 # [Th, Cap, 2]
    slot = hdr_ops.thread_id(h).reshape(-1)
    cts = u64(hdr_ops.commit_ts(h)).reshape(-1)
    slot = torch.where(com, slot, 0).clamp(0, vec.shape[0] - 1)
    out = u64(vec)
    out.scatter_reduce_(0, slot, torch.where(com, cts, 0), "amax")
    return to_i32(out)


def release_abandoned_locks(j: Journal, table: VersionedTable, dead_tid,
                            replica: int = 0) -> VersionedTable:
    """The monitoring compute server (§6.2), in place: unlock every record
    that a dead thread's unresolved entries in its live window name and
    that is locked now — all of them, not only the latest."""
    dead = torch.atleast_1d(torch.as_tensor(dead_tid)).to(
        j.used.device, torch.int64)
    live = _live_window(j)[dead]                       # [D, Cap]
    unresolved = live & ~j.resolved[replica, dead]
    mask = (j.write_mask[replica, dead] & unresolved[:, :, None]).reshape(-1)
    slots = torch.where(mask, j.slots[replica, dead].reshape(-1), 0)
    locked = hdr_ops.is_locked(
        table.cur_hdr[gidx(slots, table.n_records)])
    cas.release(table.cur_hdr, slots, mask & locked)
    return table


def rereplicate(j: Journal, survivors) -> Journal:
    """Full replication again after a server loss: every replica becomes a
    copy of the first surviving one, in place."""
    r = _pick_replica(j, 0, survivors)
    for f in ENTRY_FIELDS:
        field = getattr(j, f)
        field.copy_(field[r].clone().expand(field.shape))
    return j


def grow_replicas(j: Journal, n_replicas: int) -> Journal:
    """Extend the replica axis (a mesh expansion): each new replica is a
    copy of replica 0. A new journal."""
    if n_replicas < j.n_replicas:
        raise ValueError(
            f"cannot shrink the journal from {j.n_replicas} to "
            f"{n_replicas} replicas — grow_replicas only adds servers")
    return j._replace(**{
        f: getattr(j, f)[:1].expand(
            (n_replicas,) + getattr(j, f).shape[1:]).clone()
        for f in ENTRY_FIELDS})
