"""Multi-version record storage (paper §5.1, Figure 3).

Per pool of R records, payload width W int32 words, K old-version slots and
KO overflow slots:

* ``cur_hdr  int32 [R, 2]``, ``cur_data int32 [R, W]`` — the current version
  in place, so the common read is one one-sided read;
* ``old_hdr  int32 [R, K, 2]``, ``old_data int32 [R, K, W]`` — the circular
  old-version buffers, with ``next_write int32 [R]`` their write counter;
* ``ovf_hdr/ovf_data [R, KO, …]``, ``ovf_next int32 [R]`` — the overflow ring
  the version mover feeds.

Headers are uint32 words in int32 storage (``repro_torch._u32``). The
functions that change a table (:func:`install`, :func:`version_mover`,
:func:`compact_overflow`) update its tensors **in place** and return the same table; the readers
never write.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._u32 import gidx, rows_of, sidx
from repro_torch.core import header as hdr_ops


class VersionedTable(NamedTuple):
    cur_hdr: torch.Tensor     # int32 [R, 2]
    cur_data: torch.Tensor    # int32 [R, W]
    old_hdr: torch.Tensor     # int32 [R, K, 2]
    old_data: torch.Tensor    # int32 [R, K, W]
    next_write: torch.Tensor  # int32 [R]
    ovf_hdr: torch.Tensor     # int32 [R, KO, 2]
    ovf_data: torch.Tensor    # int32 [R, KO, W]
    ovf_next: torch.Tensor    # int32 [R]

    @property
    def n_records(self) -> int:
        return self.cur_hdr.shape[0]

    @property
    def payload_width(self) -> int:
        return self.cur_data.shape[1]

    @property
    def n_old(self) -> int:
        return self.old_hdr.shape[1]


def init_table(n_records: int, payload_width: int, n_old: int = 4,
               n_overflow: int = 8, *, device) -> VersionedTable:
    """Fresh table: version 0 by thread 0, all old slots moved (reusable),
    all overflow slots deleted (free)."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    old_hdr = z(n_records, n_old, 2)
    old_hdr[..., hdr_ops.META] = hdr_ops.MOVED_BIT
    ovf_hdr = z(n_records, n_overflow, 2)
    ovf_hdr[..., hdr_ops.META] = hdr_ops.DELETED_BIT
    return VersionedTable(
        cur_hdr=z(n_records, 2), cur_data=z(n_records, payload_width),
        old_hdr=old_hdr, old_data=z(n_records, n_old, payload_width),
        next_write=z(n_records), ovf_hdr=ovf_hdr,
        ovf_data=z(n_records, n_overflow, payload_width),
        ovf_next=z(n_records))


def read_current(tbl: VersionedTable, slots):
    """The common-case single one-sided read: header + payload in place."""
    s = gidx(slots, tbl.n_records)
    return tbl.cur_hdr[s], tbl.cur_data[s]


class VisibleRead(NamedTuple):
    hdr: torch.Tensor           # int32 [Q, 2]
    data: torch.Tensor          # int32 [Q, W]
    found: torch.Tensor         # bool [Q] — False ⇒ snapshot too old
    from_current: torch.Tensor  # bool [Q]
    from_ovf: torch.Tensor      # bool [Q]


SRC_CURRENT = 0
SRC_OLD = 1
SRC_OVF = 2


class VersionLoc(NamedTuple):
    """Locator of the newest version visible under T_R: region + position.
    When ``found`` is False it still points at the newest overflow slot."""
    found: torch.Tensor  # bool [Q]
    src: torch.Tensor    # int32 [Q] — SRC_CURRENT / SRC_OLD / SRC_OVF
    pos: torch.Tensor    # int32 [Q] — ring position (0 for SRC_CURRENT)


def _usable(h, ts_vec):
    return hdr_ops.visible(h, ts_vec) & ~hdr_ops.is_deleted(h)


def _ring_scan(region_hdr, next_ptr, slots, ts_vec, *, skip_sentinel: bool):
    """Newest-first visibility scan of one circular region (§5.1).

    ``slots`` must be in range. Returns ``(pos [Q,K] int64, hdr [Q,K,2],
    ok [Q,K], first [Q], any [Q])``; with ``skip_sentinel`` the never-written
    old-ring header (cts 0, thread 0, moved) is not usable.
    """
    K = region_hdr.shape[1]
    ages = torch.arange(K, device=slots.device)
    nx = next_ptr[slots].to(torch.int64)
    pos = torch.remainder(nx[:, None] - 1 - ages[None, :], K)
    h = region_hdr[slots[:, None], pos]
    ok = _usable(h, ts_vec)
    if skip_sentinel:
        sentinel = (hdr_ops.commit_ts(h) == 0) & (hdr_ops.thread_id(h) == 0) \
            & hdr_ops.is_moved(h)
        ok = ok & ~sentinel
    # analysis: safe(W03): boolean visibility-mask operand — no sentinels
    first = ok.to(torch.int8).argmax(dim=1)
    return pos, h, ok, first, ok.any(dim=1)


def _pick(x, first):
    return x.gather(1, first[:, None])[:, 0]


def locate_visible(tbl: VersionedTable, slots, ts_vec) -> VersionLoc:
    """Headers-only §5.1 resolution: current → old ring → overflow ring."""
    s = gidx(slots, tbl.n_records)
    cur_ok = _usable(tbl.cur_hdr[s], ts_vec)
    pos, _, _, first, any_old = _ring_scan(
        tbl.old_hdr, tbl.next_write, s, ts_vec, skip_sentinel=True)
    opos, _, _, vfirst, any_ovf = _ring_scan(
        tbl.ovf_hdr, tbl.ovf_next, s, ts_vec, skip_sentinel=False)
    src = torch.where(cur_ok, SRC_CURRENT,
                      torch.where(any_old, SRC_OLD, SRC_OVF))
    loc_pos = torch.where(cur_ok, 0, torch.where(
        any_old, _pick(pos, first), _pick(opos, vfirst)))
    return VersionLoc(found=cur_ok | any_old | any_ovf,
                      src=src.to(torch.int32), pos=loc_pos.to(torch.int32))


def gather_version(tbl: VersionedTable, slots, loc: VersionLoc):
    """Fetch (hdr, data) of the version a :class:`VersionLoc` points at."""
    s = gidx(slots, tbl.n_records)
    cur_h, cur_d = tbl.cur_hdr[s], tbl.cur_data[s]
    op = gidx(loc.pos, tbl.n_old)
    vp = gidx(loc.pos, tbl.ovf_hdr.shape[1])
    old_h, old_d = tbl.old_hdr[s, op], tbl.old_data[s, op]
    ovf_h, ovf_d = tbl.ovf_hdr[s, vp], tbl.ovf_data[s, vp]
    is_cur = (loc.src == SRC_CURRENT)[:, None]
    is_old = (loc.src == SRC_OLD)[:, None]
    hdr = torch.where(is_cur, cur_h, torch.where(is_old, old_h, ovf_h))
    data = torch.where(is_cur, cur_d, torch.where(is_old, old_d, ovf_d))
    return hdr, data


def read_visible(tbl: VersionedTable, slots, ts_vec) -> VisibleRead:
    """Newest version visible under T_R, materializing every ring version
    before the selection (the unfused rendering of §5.1)."""
    s = gidx(slots, tbl.n_records)
    cur_h, cur_d = tbl.cur_hdr[s], tbl.cur_data[s]
    cur_ok = _usable(cur_h, ts_vec)

    pos, oh, _, first, any_old = _ring_scan(
        tbl.old_hdr, tbl.next_write, s, ts_vec, skip_sentinel=True)
    od = tbl.old_data[s[:, None], pos]
    old_h = oh[torch.arange(len(s), device=s.device), first]
    old_d = od[torch.arange(len(s), device=s.device), first]

    opos, vh, _, vfirst, any_ovf = _ring_scan(
        tbl.ovf_hdr, tbl.ovf_next, s, ts_vec, skip_sentinel=False)
    vd = tbl.ovf_data[s[:, None], opos]
    ovf_h = vh[torch.arange(len(s), device=s.device), vfirst]
    ovf_d = vd[torch.arange(len(s), device=s.device), vfirst]

    c, o = cur_ok[:, None], any_old[:, None]
    hdr = torch.where(c, cur_h, torch.where(o, old_h, ovf_h))
    data = torch.where(c, cur_d, torch.where(o, old_d, ovf_d))
    return VisibleRead(hdr=hdr, data=data, found=cur_ok | any_old | any_ovf,
                       from_current=cur_ok,
                       from_ovf=~cur_ok & ~any_old & any_ovf)


class InstallResult(NamedTuple):
    table: VersionedTable
    installed: torch.Tensor  # bool [Q] — False ⇒ old slot not reusable yet


def install(tbl: VersionedTable, slots, new_hdr, new_data, mask) -> InstallResult:
    """Install write-set versions in place (§5.1 "Version Management").

    Per record: the ring slot at ``next_write mod K`` must be moved (else
    ``installed=False``); the current version moves there with lock and
    moved cleared; the new version becomes current with its lock cleared;
    ``next_write`` advances. The gathers clamp a slot out of range; the
    scatters drop it (once negatives wrap). Masked lanes that name one slot
    (one transaction writing a record twice, or two transactions of one
    priority) all move the same current version and all advance
    ``next_write``; the highest such lane writes the new current version,
    as the reference's in-order scatter does. Updates ``tbl`` in place.
    """
    R, K = tbl.n_records, tbl.n_old
    safe = gidx(torch.where(mask, slots, 0), R)
    wpos = torch.remainder(tbl.next_write[safe].to(torch.int64), K)
    reusable = hdr_ops.is_moved(tbl.old_hdr[safe, wpos])
    do = mask & reusable

    idx = sidx(torch.where(do, slots, R), R)
    rows = rows_of(idx < R)
    s, w, g = idx[rows], wpos[rows], safe[rows]
    tbl.old_hdr[s, w] = hdr_ops.with_moved(
        hdr_ops.with_lock(tbl.cur_hdr[g], False), False)
    tbl.old_data[s, w] = tbl.cur_data[g]
    tbl.next_write.index_add_(0, s, torch.ones_like(s, dtype=torch.int32))
    # every lane of a slot writes the highest lane's version (the last of
    # its run in a stable sort), so the duplicate writes agree; the slots
    # sort as int32 (R < 2**31), half the radix passes of int64
    so, order = torch.sort(s.to(torch.int32), stable=True)
    top = rows[order[torch.searchsorted(so, so, right=True) - 1]]
    tbl.cur_hdr[so.long()] = hdr_ops.with_lock(new_hdr[top], False)
    tbl.cur_data[so.long()] = new_data[top]
    return InstallResult(table=tbl, installed=do)


def version_mover(tbl: VersionedTable, budget_per_record: int = 1, *,
                  reuse_only: bool = False) -> VersionedTable:
    """The memory-server version-mover thread (§5.1 + §5.3), in place.

    Copies the oldest not-yet-moved old-ring version of every record into
    the overflow ring and sets its moved bit. With ``reuse_only`` it only
    advances into overflow slots whose deleted bit is set (reclaimed by GC)
    and otherwise stalls. Only the records that move a version are written.
    """
    R, K = tbl.n_records, tbl.n_old
    KO = tbl.ovf_hdr.shape[1]
    dev = tbl.cur_hdr.device
    ages = torch.arange(K, device=dev)
    for _ in range(budget_per_record):
        pos = torch.remainder(tbl.next_write.to(torch.int64)[:, None] + ages, K)
        meta = tbl.old_hdr[..., hdr_ops.META].gather(1, pos)
        not_moved = (meta & hdr_ops.MOVED_BIT) == 0
        has = not_moved.any(dim=1)
        opos = torch.remainder(tbl.ovf_next.to(torch.int64), KO)
        if reuse_only:
            r = torch.arange(R, device=dev)
            has = has & ((tbl.ovf_hdr[r, opos, hdr_ops.META]
                          & hdr_ops.DELETED_BIT) != 0)
        rows = rows_of(has)
        # analysis: safe(W03): boolean not-moved mask operand — no sentinels
        src = _pick(pos[rows], not_moved[rows].to(torch.int8).argmax(dim=1))
        mh = tbl.old_hdr[rows, src]
        md = tbl.old_data[rows, src]
        tbl.ovf_hdr[rows, opos[rows]] = hdr_ops.with_deleted(mh, False)
        tbl.ovf_data[rows, opos[rows]] = md
        tbl.ovf_next.copy_(torch.remainder(tbl.ovf_next + has.to(torch.int32),
                                           KO))
        tbl.old_hdr[rows, src] = hdr_ops.with_moved(mh, True)
    return tbl


def compact_overflow(tbl: VersionedTable) -> VersionedTable:
    """Lazy truncation of GC-marked overflow versions (§5.3), in place:
    every deleted-bit overflow slot becomes the reusable sentinel (a zero
    header with only the deleted bit, a zero payload). Idempotent and
    invisible to reads (deleted versions are never returned)."""
    dead = (tbl.ovf_hdr[..., hdr_ops.META] & hdr_ops.DELETED_BIT) != 0
    tbl.ovf_hdr[..., hdr_ops.META].masked_fill_(dead, hdr_ops.DELETED_BIT)
    tbl.ovf_hdr[..., hdr_ops.CTS].masked_fill_(dead, 0)
    tbl.ovf_data.masked_fill_(dead[..., None], 0)
    return tbl
