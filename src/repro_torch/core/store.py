"""The NAM store (paper §2.1, §5): the unified versioned record pool, the
timestamp-vector oracle state and the extend allocator for inserts (§5.3),
the §5.2 directory loader, and the pool range-partitioned over memory
servers (:func:`distributed_round`).

**The memory servers on one device.** The reference places each server on
a device of a mesh axis; on one card the servers are a leading shard axis:

- the pool is one :func:`pad_table`-padded ``VersionedTable`` of ``S·Rs``
  rows, ``Rs = ceil(R / S)``, and server ``s`` owns the contiguous rows
  ``[s·Rs, (s+1)·Rs)`` (:func:`shard_view`, a view with no copy), so
  checkpoints, ``wal.replay``, GC and recovery work on the one table;
- the §5.2 directory is one bucket array; server ``s`` owns buckets
  ``[s·B/S, (s+1)·B/S)`` (:func:`shard_directory`);
- a partitioned timestamp vector is the :func:`pad_vector`-padded tensor:
  the all-gather of its parts is its first ``n_slots`` words
  (:func:`gather_vector`, a view), and each server's write-back of its
  part is the in-place update of that view;
- each server's phase uses local slots (:func:`_local_slots`: an
  out-of-shard lane gets ``Rs``, which a scatter drops and a gather
  clamps), its contributions are stacked on a leading ``[S, ...]`` axis,
  and the reference's ``psum`` is the sum over it (masks summed as int32
  and compared ``> 0``; one server at most contributes a nonzero header,
  payload or directory value, so the int32 sum of uint32 patterns is
  exact);
- the plain work of all servers runs as one op over the stacked views
  (a server's local slot ``l`` is row ``s·Rs + l`` of the pool), while a
  kernel launches once a server on the server's view.

The commit decision stays on the device: a round adds no host
synchronisation to the single-server round.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch._u32 import gidx, sidx, to_i32, u64
from repro_torch.core import annotations as anno, cas, gc as gc_ops, \
    hashtable as ht, header as hdr_ops, mvcc, wal
from repro_torch.core.catalog import Catalog
from repro_torch.core.mvcc import VersionedTable
from repro_torch.core.si import TxnBatch
from repro_torch.core.tsoracle import VectorOracle, VectorState


class ExtendState(NamedTuple):
    """§5.3 extend allocator: each (thread, insert region) owns a
    contiguous extend of slots and bumps a private cursor."""
    cursor: torch.Tensor  # int32 [n_threads, n_regions]


class NAMStore(NamedTuple):
    table: VersionedTable
    oracle_state: VectorState
    extends: ExtendState


def init_store(catalog: Catalog, oracle: VectorOracle, *, n_old: int = 2,
               n_overflow: int = 2, width: int | None = None,
               n_insert_regions: int = 1, device) -> NAMStore:
    """Versioned pool + oracle + extends for a catalog. Every record starts
    existing; the caller pre-marks insert regions with
    :func:`mark_region_deleted` / :func:`mark_slots_deleted`."""
    w = width or max(s.width for s in catalog.specs.values())
    tbl = mvcc.init_table(catalog.total_records, w, n_old=n_old,
                          n_overflow=n_overflow, device=device)
    return NAMStore(
        table=tbl, oracle_state=oracle.init(device),
        extends=ExtendState(cursor=torch.zeros(
            (oracle.n_threads, n_insert_regions), dtype=torch.int32,
            device=device)))


def mark_region_deleted(store: NAMStore, base: int, count: int) -> NAMStore:
    """Pre-mark an insert region's records as deleted (non-existent)."""
    store.table.cur_hdr[base:base + count, hdr_ops.META] |= hdr_ops.DELETED_BIT
    return store


def mark_slots_deleted(store: NAMStore, slots) -> NAMStore:
    """Pre-mark arbitrary record slots as deleted, in place."""
    slots = slots.to(torch.int64)
    meta = store.table.cur_hdr[:, hdr_ops.META]
    meta[slots] = meta[slots] | hdr_ops.DELETED_BIT
    return store


def build_directory(keys, slots, n_buckets: int, *,
                    max_probes: int = 16) -> ht.HashTable:
    """Bulk-build the key → record-slot hash index (§5.2). A key that finds
    no bucket within ``max_probes`` is a load error: raise."""
    table = ht.init(n_buckets, device=keys.device)
    table, placed = ht.insert(table, keys, slots, max_probes=max_probes)
    n_dropped = int((placed < 0).sum())
    if n_dropped:
        raise ValueError(
            f"directory build dropped {n_dropped}/{keys.shape[0]} keys: "
            f"probe chains exceeded max_probes={max_probes} at "
            f"{n_buckets} buckets (load factor "
            f"{keys.shape[0] / n_buckets:.2f}) — grow the bucket array")
    return table


def allocate(extends: ExtendState, tid, region, n, region_base, extend_size,
             threads: int):
    """Allocate ``n`` slots from thread ``tid``'s extend of ``region``:
    ``region_base + tid * extend_size + cursor`` (the compute server
    computes the remote address itself, no RPC). Returns ``(new_extends,
    first_slot)``; the input state is not modified."""
    cur = extends.cursor[tid, region]
    first = region_base + tid * extend_size + cur
    new = extends.cursor.clone()
    new.index_put_((torch.as_tensor(tid, device=new.device),
                    torch.as_tensor(region, device=new.device)),
                   torch.as_tensor(n, dtype=torch.int32, device=new.device),
                   accumulate=True)
    return ExtendState(cursor=new), first


# ---------------------------------------------------------------------------
# Placement: the memory servers as a leading shard axis (module docstring)
# ---------------------------------------------------------------------------
def pad_table(table: VersionedTable, multiple: int):
    """Pad the record axis to a multiple of ``multiple`` servers. Filler
    records are deleted (reads report not found) and their old-version
    slots carry the reusable "moved" sentinel, as ``mvcc.init_table``
    makes them; no transaction addresses them. Returns ``(padded_table,
    n_padded_records)``: new tensors, or ``table`` itself when ``multiple``
    divides its records."""
    n = table.n_records
    pad = (-n) % multiple
    if pad == 0:
        return table, n
    filler = mvcc.init_table(pad, table.payload_width, n_old=table.n_old,
                             n_overflow=table.ovf_hdr.shape[1],
                             device=table.cur_hdr.device)
    filler = filler._replace(
        cur_hdr=hdr_ops.with_deleted(filler.cur_hdr, True))
    return VersionedTable(*(torch.cat([a, b]) for a, b in zip(table, filler))
                          ), n + pad


def shard_table(n_shards: int, table: VersionedTable) -> VersionedTable:
    """The pool range-partitioned over ``n_shards`` servers: on one device
    a check that its record axis divides (pad it with :func:`pad_table`)."""
    if table.n_records % n_shards:
        raise ValueError(f"pool has {table.n_records} records, not "
                         f"divisible over {n_shards} memory servers — "
                         f"pad_table it first")
    return table


def shard_view(table: VersionedTable, s: int,
               shard_records: int) -> VersionedTable:
    """Server ``s``'s rows ``[s·Rs, (s+1)·Rs)`` of the padded pool as a
    ``VersionedTable`` of views: no copy, contiguous, written in place."""
    lo = s * shard_records
    return VersionedTable(*(t[lo:lo + shard_records] for t in table))


def pad_vector(vec: torch.Tensor, multiple: int):
    """Zero-pad the timestamp vector to a multiple of ``multiple`` servers
    (a 3→5 expansion need not divide the slots). Pad slots belong to no
    thread and are stripped after every gather. Returns ``(padded_vec,
    n_padded_slots)``; the dividing case returns ``vec`` itself."""
    n = vec.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return vec, n
    return torch.cat([vec, vec.new_zeros((pad,))]), n + pad


def shard_vector(n_shards: int, vec: torch.Tensor) -> torch.Tensor:
    """The vector range-partitioned over the servers (§4.2 "Partitioning
    of T_R", for ``shard_vector=True``): :func:`pad_vector`-padded."""
    return pad_vector(vec, n_shards)[0]


def gather_vector(vec: torch.Tensor, n_slots: int) -> torch.Tensor:
    """The all-gather of a partitioned vector's parts with the padding
    stripped: a view of its first ``n_slots`` words, so an in-place update
    of it is each server's write-back of its part."""
    return vec[:n_slots]


def shard_directory(n_shards: int, directory: ht.HashTable) -> ht.HashTable:
    """The §5.2 bucket array range-partitioned over the servers
    (``hashtable.partition_of`` names a key's owner): a check that the
    bucket count divides."""
    if directory.n_buckets % n_shards:
        raise ValueError(f"directory has {directory.n_buckets} buckets, not "
                         f"divisible over {n_shards} memory servers")
    return directory


def shard_journal(n_shards: int, journal: wal.Journal) -> wal.Journal:
    """A §6.2 journal with one replica a server, so a server failure
    leaves ``n_shards - 1`` identical survivors: a check that
    ``n_replicas`` is the server count."""
    if journal.n_replicas != n_shards:
        raise ValueError(
            f"journal has {journal.n_replicas} replicas but the mesh holds "
            f"{n_shards} memory servers — init the journal with "
            f"n_replicas={n_shards}")
    return journal


# ---------------------------------------------------------------------------
# Distributed execution: one SI round over the memory servers
# ---------------------------------------------------------------------------
class DistRoundOut(NamedTuple):
    """Per-round outputs of :func:`distributed_round` (the table and the
    vector travel separately); the counters feed ``si.count_ops``."""
    committed: torch.Tensor      # bool  [T]
    snapshot_miss: torch.Tensor  # bool  [T]
    read_data: torch.Tensor      # int32 [T, RS, W]
    txn_found: torch.Tensor      # bool  [T]
    from_current: torch.Tensor   # bool  [T, RS]
    from_ovf: torch.Tensor       # bool  [T, RS]
    read_found: torch.Tensor     # bool  [T, RS]
    n_installs: torch.Tensor     # int64 [] — installs across all servers
    n_releases: torch.Tensor     # int64 [] — abort-path lock releases


class ReadOnlyOut(NamedTuple):
    """Outputs of :func:`distributed_readonly_round`."""
    read_data: torch.Tensor      # int32 [T, RS, W]
    found: torch.Tensor          # bool  [T, RS] (True where masked out)
    from_current: torch.Tensor   # bool  [T, RS]


def _local_slots(slots, base, count):
    """Global slots as local ones; out-of-shard → ``count`` (a scatter
    drops it, a gather clamps it). With ``base`` [S, 1] every server's at
    once, ``[S, Q]``."""
    loc = slots - base
    inside = (loc >= 0) & (loc < count)
    return torch.where(inside, loc, count), inside


def _bases(n_shards: int, per: int, device) -> torch.Tensor:
    """The first global index of every server's range, int64 [S, 1]."""
    return torch.arange(n_shards, dtype=torch.int64, device=device)[:, None] \
        * per


def _psum(x):
    """The reference's ``psum`` over the stacked servers of an int32
    contribution (at most one nonzero per lane, so int32 is exact)."""
    return x.sum(0, dtype=torch.int32)


def _any(mask):
    """``psum`` of a bool contribution as int32, compared ``> 0``."""
    return mask.to(torch.int32).sum(0) > 0


def _resolve_keys(n_shards, directory, read_keys, key_mask, slots,
                  max_probes):
    """§5.2 key resolution against the partitioned directory: every server
    walks the probe sequence over its buckets (``lookup_shard``) and the
    sum over the servers is the lookup. Returns ``(flat slots, key_ok)``."""
    B = directory.n_buckets
    per = B // n_shards
    vsum, khit = ht.lookup_shard(
        directory.keys.view(n_shards, per), directory.vals.view(n_shards, per),
        read_keys.reshape(-1), _bases(n_shards, per, slots.device), B,
        max_probes=max_probes)
    vsum, khit = _psum(vsum), _any(khit)
    kfound = khit & (vsum >= 0)
    km = key_mask.reshape(-1)
    return torch.where(km, torch.where(kfound, vsum, 0), slots), \
        ~km | kfound


def _visible_reads(table: VersionedTable, n_shards: int, flat, vec, *,
                   batched_probe: bool = False):
    """One-sided visible reads of global slots ``flat`` [Q]: every server
    reads its resident lanes at local slots, the others contribute zeros,
    and the sum over the servers is the read. Returns ``(hdr [Q, 2], data
    [Q, W], found, from_current, from_ovf)`` before the key mask."""
    Rs = table.n_records // n_shards
    bases = _bases(n_shards, Rs, flat.device)
    loc, inside = _local_slots(flat, bases, Rs)
    safe = torch.where(inside, loc, 0)
    rows = (bases + safe).reshape(-1)    # local slot of view s, as a pool row
    if batched_probe:
        # the kernel in locate-only mode, one launch a server on its view;
        # key resolution stays lookup_shard + the sum (the bucket array is
        # partitioned, so no server walks a whole probe sequence)
        from repro_torch.kernels.hash_probe import ops as probe_ops
        locs = [probe_ops.batched_probe(
            None, None, shard_view(table, s, Rs), vec, safe[s].to(torch.int32),
            None, None)[1:] for s in range(n_shards)]
        f_loc, src, pos = (torch.cat(x) for x in zip(*locs))
        hdr, data = mvcc.gather_version(
            table, rows, mvcc.VersionLoc(found=f_loc, src=src, pos=pos))
        found = f_loc
        cur, ovf = f_loc & (src == mvcc.SRC_CURRENT), \
            f_loc & (src == mvcc.SRC_OVF)
    else:
        vr = mvcc.read_visible(table, rows, vec)
        hdr, data, found = vr.hdr, vr.data, vr.found
        cur, ovf = vr.from_current, vr.from_ovf
    Q = flat.shape[0]
    part = lambda x: x.reshape((n_shards, Q) + x.shape[1:])
    hdr = _psum(torch.where(inside[:, :, None], part(hdr), 0))
    data = _psum(torch.where(inside[:, :, None], part(data), 0))
    return (hdr, data, _any(inside & part(found)), _any(inside & part(cur)),
            _any(inside & part(ovf)))


def distributed_round(n_shards: int, oracle: VectorOracle,
                      compute_fn: Callable, shard_records: int, *,
                      shard_vector: bool = False, n_dir_buckets: int = 0,
                      dir_max_probes: int = 16, with_journal: bool = False,
                      fused_commit: bool = False,
                      batched_probe: bool = False):
    """Build a ``round(table, vec, batch, aux)`` executor over ``n_shards``
    memory servers, each owning ``shard_records`` contiguous rows of the
    padded pool ``table`` (module docstring). The batch (and ``aux``,
    threaded to ``compute_fn(read_hdr, read_data, vec, aux) -> new_data``)
    is seen by every server, which applies only its own slots.

    ``shard_vector`` range-partitions the timestamp vector over the
    servers (the ``PartitionedVectorOracle`` deployment): ``vec`` is the
    :func:`pad_vector`-padded vector, read through :func:`gather_vector`.
    ``n_dir_buckets > 0`` is the §5.2 key-addressed path: ``round_fn``
    takes ``directory``, ``read_keys`` and ``key_mask``, and marked reads
    resolve their slot with ``lookup_shard`` on every server and the sum.
    ``with_journal`` takes ``journal`` (one replica a server), ``round_no``
    and ``seq``: every server logs the same intents before install and the
    same outcomes after the decision, and the journal is returned fourth.

    ``batched_probe`` resolves each server's resident reads with one
    locate-only ``batched_probe`` launch on its view. ``fused_commit``
    runs the commit kernel's decide/apply double launch a server
    (:func:`commit_on_servers`).

    Returns ``(round_fn, n_shards)`` with ``round_fn(table, vec, batch,
    aux, active=None, *, journal=None, round_no=0, seq=0, directory=None,
    read_keys=None, key_mask=None) -> (table, vec, DistRoundOut[,
    journal])``; ``table``, ``vec`` and ``journal`` are updated in place.
    ``active`` (bool [T]) marks the threads running a transaction.
    """
    if not isinstance(oracle, VectorOracle):
        raise ValueError(
            f"distributed_round needs a vector oracle, whose state is the "
            f"vector alone (a VectorState): {type(oracle).__name__} keeps "
            f"more state than the servers carry")
    if n_dir_buckets and n_dir_buckets % n_shards:
        raise ValueError(f"n_dir_buckets ({n_dir_buckets}) must divide over "
                         f"{n_shards} memory servers")
    Rs, S = shard_records, n_shards

    def round_fn(table: VersionedTable, vec, batch: TxnBatch, aux,
                 active=None, *, journal=None, round_no=0, seq=0,
                 directory=None, read_keys=None, key_mask=None):
        if (journal is not None) != with_journal:
            raise ValueError(
                "journal argument does not match the executor: build "
                f"distributed_round(with_journal={with_journal}) and pass "
                "a journal iff it is True")
        if table.n_records != S * Rs:
            raise ValueError(f"table has {table.n_records} records, not "
                             f"{S} servers of {Rs}")
        dev = batch.read_slots.device
        T, RS = batch.read_slots.shape
        WS = batch.write_ref.shape[1]
        W = table.payload_width
        if active is None:
            active = torch.ones((T,), dtype=torch.bool, device=dev)

        # ---- 1. read the timestamp vector (gather the partitions) -------
        live = gather_vector(vec, oracle.n_slots) if shard_vector else vec
        snap = live.clone()      # the one-sided read: a snapshot

        # ---- 2a. key resolution against the partitioned directory -------
        flat = batch.read_slots.reshape(-1)
        key_ok = torch.ones(flat.shape, dtype=torch.bool, device=dev)
        if n_dir_buckets:
            flat, key_ok = _resolve_keys(S, directory, read_keys, key_mask,
                                         flat, dir_max_probes)
        read_slots = flat.reshape(T, RS)

        # ---- 2b. one-sided visible reads (each server, then the sum) ----
        # key_ok masks a directory miss's outcomes wholesale (it resolved
        # to slot 0), as si.run_round does
        hdr, data, fnd, fcur, fovf = _visible_reads(
            table, S, flat, snap, batched_probe=batched_probe)
        read_hdr = hdr.reshape(T, RS, 2)
        read_data = data.reshape(T, RS, W)
        read_found = (fnd & key_ok).reshape(T, RS)
        from_current = (fcur & key_ok).reshape(T, RS)
        from_ovf = (fovf & key_ok).reshape(T, RS)
        txn_found = (read_found | ~batch.read_mask).all(dim=1)

        # ---- 3. transaction logic (on the compute server) ----------------
        new_data = compute_fn(read_hdr, read_data, snap, aux)

        # ---- 4. commit timestamps, created locally ----------------------
        slot_ids = oracle.slot_of_thread(batch.tid)
        txn_ok = txn_found & active
        if hasattr(oracle, "next_commit_ts_batch"):
            cts = oracle.next_commit_ts_batch(VectorState(vec=snap),
                                              batch.tid, txn_ok)
        else:
            cts = to_i32(u64(snap[gidx(slot_ids, snap.shape[0])]) + 1)
        new_hdr = hdr_ops.pack(slot_ids[:, None].expand(T, WS),
                               cts[:, None].expand(T, WS))

        # ---- 5. stage the write-set CAS requests -------------------------
        wref = batch.write_ref.clamp(0, RS - 1).to(torch.int64)
        wslots = read_slots.gather(1, wref)
        expected = read_hdr.gather(1, wref[:, :, None].expand(T, WS, 2))
        req_active = (batch.write_mask & txn_ok[:, None]).reshape(-1)
        txn_of_req = torch.arange(T, dtype=torch.int32,
                                  device=dev)[:, None].expand(T, WS) \
            .reshape(-1)

        # ---- 6. the WAL intents (§6.2), before install ------------------
        # every server writes the same entry into its replica (the
        # broadcast journal write); slots are logged global, so any
        # survivor replays the whole pool. They depend only on commit
        # inputs, so both commit renderings log the same bytes
        if with_journal:
            wal.append_intent(
                journal, batch.tid, snap,
                *wal.pad_writes(journal, wslots, new_hdr, new_data,
                                req_active.reshape(T, WS)),
                round_no=round_no, seq=seq)

        # ---- 5.-8. validate + lock, decide, install, release ------------
        # the commit kernel's scatter-max is the vector oracle's
        # make-visible; another oracle's kernel writes a scratch copy
        std_vis = type(oracle).make_visible is VectorOracle.make_visible
        committed, granted, do_install = commit_on_servers(
            table, live if std_vis else live.clone(), S, wslots.reshape(-1),
            expected.reshape(-1, 2),
            batch.tid[:, None].expand(T, WS).reshape(-1), req_active,
            txn_of_req, new_hdr.reshape(-1, 2), new_data.reshape(-1, W),
            txn_ok, slot_ids, cts, fused_commit=fused_commit)
        release_mask = anno.tag(granted & ~committed[gidx(txn_of_req, T)],
                                anno.LOCK_RELEASED)

        # ---- 9. make visible --------------------------------------------
        if journal is not None:   # the outcome after the decision (§3.2)
            wal.append_outcome(journal, batch.tid, committed)
        if not (fused_commit and std_vis):
            oracle.make_visible(VectorState(vec=live), batch.tid, cts,
                                committed)

        out = DistRoundOut(
            committed=committed, snapshot_miss=~txn_found,
            read_data=read_data, txn_found=txn_found,
            from_current=from_current, from_ovf=from_ovf,
            read_found=read_found, n_installs=do_install.sum(),
            n_releases=release_mask.sum())
        if with_journal:
            return table, vec, out, journal
        return table, vec, out

    return round_fn, n_shards


def commit_on_servers(table: VersionedTable, vec, n_shards: int, req_slots,
                      req_expected, req_prio, req_active, txn_of_req,
                      new_hdr, new_data, txn_ok, txn_slot, cts, *,
                      fused_commit: bool = False):
    """Phases 5-8 of Listing 1 over the servers for a flat request array
    with global slots (arguments as ``si.commit_write_sets`` and the
    commit kernel's make-visible inputs): each server validates, locks,
    installs and releases only its own slots, at local slots of its view,
    and a transaction commits iff no server failed any of its requests.

    With ``fused_commit`` it is the commit kernel's decide/apply double
    launch: every server's decide-only launch first (no decide reads what
    an apply wrote: the views are disjoint and the kernel never reads
    ``vec``), then the sum of their failure counts, then every server's
    apply launch with ``ext_fails = total - local``. Every apply
    scatter-maxes the same (slot, cts) into the one vector; the max is
    idempotent, so the S applies equal the reference's per-server
    make-visible. Without it, the reference's plain rendering: arbitrate
    (locks taken), the summed failures, install and release, each one op
    over the stacked views; the caller then makes the commits visible.

    Returns ``(committed bool [T], granted bool [S, Q], do_install bool
    [S, Q])``; the table (and with ``fused_commit`` the vector) is updated
    in place.
    """
    S, T = n_shards, txn_ok.shape[0]
    Rs = table.n_records // S
    bases = _bases(S, Rs, req_slots.device)
    wloc, winside = _local_slots(req_slots.to(torch.int64), bases, Rs)
    mine = req_active & winside                                  # [S, Q]
    lslots = torch.where(winside, wloc, 0).to(torch.int32)
    if fused_commit:
        from repro_torch.kernels.commit import ops as commit_ops
        views = [shard_view(table, s, Rs) for s in range(S)]

        def commit(s, ext, decide_only=False):
            return commit_ops.fused_commit(
                views[s], vec, lslots[s], req_expected, req_prio, mine[s],
                txn_of_req, new_hdr, new_data, txn_ok, txn_slot, cts, ext,
                decide_only=decide_only)

        zero = torch.zeros((T,), dtype=torch.int32, device=txn_ok.device)
        fails = torch.stack([commit(s, zero, True).fails
                             for s in range(S)])                 # [S, T]
        total = _psum(fails)
        applied = [commit(s, total - fails[s]) for s in range(S)]
        return (anno.tag(applied[0].committed, anno.COMMIT_COMMITTED),
                anno.tag(torch.stack([a.granted for a in applied]),
                         anno.LOCK_GRANTED),
                torch.stack([a.do_install for a in applied]))

    # ---- 5. validate + lock on the owning server -------------------------
    rows = (bases + lslots).reshape(-1)       # server s's local slots
    granted = anno.tag(cas.arbitrate(
        table.cur_hdr, rows, req_expected.repeat(S, 1), req_prio.repeat(S),
        mine.reshape(-1)).granted.reshape(S, -1), anno.LOCK_GRANTED)
    safe = torch.where(mine, bases + lslots, 0).reshape(-1)
    vpos = torch.remainder(table.next_write[safe].to(torch.int64),
                           table.n_old)
    effective = granted & hdr_ops.is_moved(
        table.old_hdr[safe, vpos]).reshape(S, -1)

    # ---- 6. the global decision: the sum of the failures -----------------
    fails = torch.zeros((S, T + 1), dtype=torch.int32, device=txn_ok.device)
    fails.scatter_add_(1, sidx(txn_of_req, T).expand(S, -1),
                       (mine & ~effective).to(torch.int32))
    committed = anno.tag((_psum(fails[:, :T]) == 0) & txn_ok,
                         anno.COMMIT_COMMITTED)

    # ---- 7./8. install / release on the owning server --------------------
    txn_c = committed[gidx(txn_of_req, T)]
    do_install = effective & txn_c
    mvcc.install(table, rows, new_hdr.repeat(S, 1), new_data.repeat(S, 1),
                 do_install.reshape(-1))
    cas.release(table.cur_hdr, rows,
                anno.tag(granted & ~txn_c, anno.LOCK_RELEASED).reshape(-1))
    return committed, granted, do_install


def distributed_readonly_round(n_shards: int, shard_records: int, *,
                               n_dir_buckets: int = 0,
                               dir_max_probes: int = 16):
    """Build a snapshot-read executor over the servers: read-only
    transactions never validate (§1.2), so a round is phases 1-2 of
    Listing 1 (gather the vector, one-sided visible reads), and the table
    and the vector are not written. ``n_dir_buckets > 0`` adds the §5.2
    key-addressed path as in :func:`distributed_round`; a directory miss
    reads as not found. A partitioned vector is read whole, its padding
    included, as the reference's gather reads it (no header names a pad
    slot), so the executor is the same for both vector placements.

    Returns ``ro_fn(table, vec, read_slots, read_mask, *, directory=None,
    read_keys=None, key_mask=None) -> ReadOnlyOut`` (``read_slots`` int32
    [T, RS], ``read_mask`` bool [T, RS]; no ``read_keys`` on a key engine
    reads by slot).
    """
    if n_dir_buckets and n_dir_buckets % n_shards:
        raise ValueError(f"n_dir_buckets ({n_dir_buckets}) must divide over "
                         f"{n_shards} memory servers")

    def ro_fn(table: VersionedTable, vec, read_slots, read_mask, *,
              directory=None, read_keys=None, key_mask=None):
        if table.n_records != n_shards * shard_records:
            raise ValueError(f"table has {table.n_records} records, not "
                             f"{n_shards} servers of {shard_records}")
        T, RS = read_slots.shape
        W = table.payload_width
        flat = read_slots.reshape(-1)
        key_ok = torch.ones(flat.shape, dtype=torch.bool, device=flat.device)
        if n_dir_buckets and read_keys is not None:
            flat, key_ok = _resolve_keys(n_shards, directory, read_keys,
                                         key_mask, flat, dir_max_probes)
        _, data, fnd, fcur, _ = _visible_reads(table, n_shards, flat, vec)
        return ReadOnlyOut(
            read_data=data.reshape(T, RS, W),
            found=(fnd & key_ok).reshape(T, RS) | ~read_mask,
            from_current=(fcur & key_ok).reshape(T, RS))

    return ro_fn


# ---------------------------------------------------------------------------
# Distributed garbage collection: the per-memory-server §5.3 GC thread
# ---------------------------------------------------------------------------
def init_shard_logs(n_shards: int, n_snapshots: int, n_slots: int, *,
                    device=None) -> gc_ops.SnapshotLog:
    """One §5.3 snapshot log per server, stacked on a leading shard axis,
    on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return gc_ops.SnapshotLog(
        times=torch.full((n_shards, n_snapshots), -1, dtype=torch.int32,
                         device=dev),
        vecs=torch.zeros((n_shards, n_snapshots, n_slots), dtype=torch.int32,
                         device=dev))


def distributed_gc_round(n_shards: int, *, shard_vector: bool = False,
                         n_vec_slots: int | None = None):
    """Build the per-server GC sweep (§5.3): each server runs
    ``gc.gc_round`` on its own view with its own snapshot log. A
    partitioned vector is gathered first (and stripped to ``n_vec_slots``,
    the oracle's width), so every server logs the same full vector, its
    safe vector is the single-server one, and the sweep of its rows equals
    the single-server sweep of those rows. The sweep is per record, so all
    servers' steps are one ``gc_round`` over the whole padded pool with
    server 0's log, whose row the other servers' logs then copy.

    Returns ``gc_fn(table, vec, logs, now, max_txn_time) -> (table, logs)``
    with ``logs`` from :func:`init_shard_logs`; both are updated in place.
    """

    def gc_fn(table: VersionedTable, vec, logs: gc_ops.SnapshotLog, now,
              max_txn_time):
        if shard_vector and n_vec_slots is not None:
            vec = gather_vector(vec, n_vec_slots)
        gc_ops.gc_round(table, vec, gc_ops.SnapshotLog(
            times=logs.times[0], vecs=logs.vecs[0]), now, max_txn_time)
        logs.times[1:] = logs.times[0]
        logs.vecs[1:] = logs.vecs[0]
        return table, logs

    return gc_fn


# ---------------------------------------------------------------------------
# Online scale-out: re-place a live store onto more memory servers
# ---------------------------------------------------------------------------
def expand_mesh(n_shards: int, table: VersionedTable, vec: torch.Tensor, *,
                n_records: int, vector_sharded: bool = False,
                directory: ht.HashTable | None = None,
                journal: wal.Journal | None = None,
                gc_logs: gc_ops.SnapshotLog | None = None):
    """The storage half of online scale-out (§4.3): re-place the merged
    pool and vector over ``n_shards`` servers. The pool is trimmed of the
    old :func:`pad_table` filler (``n_records``) and re-padded, the vector
    re-padded (when ``vector_sharded``; ``vec`` is unpadded), the directory
    checked against the new bucket ranges, the journal grown to one replica
    a server (``wal.grow_replicas``: the replicas are identical, so a
    joiner's is a copy), and the snapshot logs copied from server 0's
    (every server logs the same full vector). Returns ``(table, vec,
    directory, journal, gc_logs)``, ``None`` where nothing was given."""
    tbl = VersionedTable(*(t[:n_records] for t in table))
    tbl = shard_table(n_shards, pad_table(tbl, n_shards)[0])
    if vector_sharded:
        vec = shard_vector(n_shards, vec)
    if directory is not None:
        directory = shard_directory(n_shards, directory)
    if journal is not None:
        journal = shard_journal(n_shards, wal.grow_replicas(journal, n_shards))
    if gc_logs is not None:
        gc_logs = gc_ops.SnapshotLog(*(
            x[:1].expand((n_shards,) + x.shape[1:]).clone() for x in gc_logs))
    return tbl, vec, directory, journal, gc_logs
