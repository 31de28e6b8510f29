"""The end-to-end Snapshot Isolation protocol (paper §3.1 Listing 1 + §4-6).

One call of :func:`run_round` executes one transaction per execution thread,
batched. The phases are Listing 1's: read the timestamp vector T_R, build
the read-set with visible reads (§5.1, optionally key-addressed through the
§5.2 hash index), compute the write-set, create commit timestamps locally,
validate + lock each written record with one arbitrated CAS, install the
write-sets of committed transactions, release the locks of aborted ones,
and make commits visible in T_R.

The pool and the vector are updated **in place**; the returned
:class:`RoundResult` carries the same tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch._u32 import gidx, sidx, to_i32, u64
from repro_torch.core import annotations as anno, cas, hashtable as ht, \
    header as hdr_ops, mvcc, wal
from repro_torch.core.mvcc import VersionedTable
from repro_torch.core.tsoracle import VectorOracle, VectorState


class TxnBatch(NamedTuple):
    """One transaction per execution thread; ``write_ref`` indexes into the
    transaction's own read-set (the CAS expectation is the header read)."""
    tid: torch.Tensor         # int32 [T]
    read_slots: torch.Tensor  # int32 [T, RS]
    read_mask: torch.Tensor   # bool  [T, RS]
    write_ref: torch.Tensor   # int32 [T, WS]
    write_mask: torch.Tensor  # bool  [T, WS]


class KeyedReads(NamedTuple):
    """Key-addressed reads: where ``mask`` is set the record slot is
    resolved through the hash index with ``keys`` (uint32 words); a miss
    reports not-found and aborts the transaction via ``snapshot_miss``."""
    keys: torch.Tensor  # int32 [T, RS]
    mask: torch.Tensor  # bool  [T, RS]


class OpCounts(NamedTuple):
    """Per-round RDMA-op accounting."""
    ts_reads: torch.Tensor
    ts_read_bytes: torch.Tensor
    record_reads: torch.Tensor
    cas_ops: torch.Tensor
    writes: torch.Tensor
    bytes_moved: torch.Tensor


class VisStats(NamedTuple):
    """Per-round visibility accounting (§5.1/§5.3 telemetry)."""
    n_reads: torch.Tensor
    n_current: torch.Tensor
    n_ovf: torch.Tensor
    n_miss: torch.Tensor


def vis_stats(read_mask, found, from_current, from_ovf,
              active=None) -> VisStats:
    m = read_mask if active is None else read_mask & active[:, None]
    return VisStats(n_reads=m.sum(), n_current=(m & from_current).sum(),
                    n_ovf=(m & from_ovf).sum(), n_miss=(m & ~found).sum())


class RoundResult(NamedTuple):
    table: VersionedTable
    oracle_state: VectorState
    committed: torch.Tensor      # bool [T]
    snapshot_miss: torch.Tensor  # bool [T]
    read_data: torch.Tensor      # int32 [T, RS, W]
    ops: OpCounts
    vis: VisStats
    journal: Optional[wal.Journal] = None


ComputeFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

DIR_PROBE_BYTES = 8  # one §5.2 bucket-cluster read: key + slot


def count_ops(oracle, batch: TxnBatch, txn_found, from_current, n_installs,
              n_releases, n_committed, payload_width: int,
              payload_bytes: int = 0, n_txns=None,
              active=None, n_index_probes=0) -> OpCounts:
    """RDMA-op accounting for one round (the reference's cost profile)."""
    T = batch.read_slots.shape[0]
    if n_txns is None:
        n_txns = T
    read_mask, write_mask = batch.read_mask, batch.write_mask
    if active is not None:
        read_mask = read_mask & active[:, None]
        write_mask = write_mask & active[:, None]
    n_active_r = read_mask.sum()
    n_active_w = (write_mask & txn_found[:, None]).sum()
    vec_bytes = 4 * getattr(oracle, "n_slots", T)
    rec_bytes = 8 + 4 * payload_width if payload_bytes == 0 else payload_bytes
    return OpCounts(
        ts_reads=torch.as_tensor(n_txns),
        ts_read_bytes=torch.as_tensor(n_txns * vec_bytes),
        record_reads=n_active_r + (~from_current & read_mask).sum()
        + n_index_probes,
        cas_ops=n_active_w,
        writes=2 * n_installs + n_releases + n_committed,
        bytes_moved=(n_active_r + 2 * n_installs) * rec_bytes
        + n_txns * vec_bytes + n_index_probes * DIR_PROBE_BYTES)


def count_readonly_ops(oracle, read_mask, from_current, n_txns,
                       payload_width: int, payload_bytes: int = 0,
                       n_index_probes=0) -> OpCounts:
    """RDMA-op accounting for a round of read-only transactions: one vector
    fetch per transaction and one read per record (old-version probes
    counted like the write path's), no CAS and no writes (§1.2);
    ``n_index_probes`` charges the §5.2 directory probes."""
    n_reads = read_mask.sum()
    vec_bytes = 4 * getattr(oracle, "n_slots", 1)
    rec_bytes = 8 + 4 * payload_width if payload_bytes == 0 else payload_bytes
    zero = torch.zeros((), dtype=torch.int64, device=read_mask.device)
    return OpCounts(
        ts_reads=torch.as_tensor(n_txns),
        ts_read_bytes=torch.as_tensor(n_txns * vec_bytes),
        record_reads=n_reads + (~from_current & read_mask).sum()
        + n_index_probes,
        cas_ops=zero, writes=zero,
        bytes_moved=n_reads * rec_bytes + n_txns * vec_bytes
        + n_index_probes * DIR_PROBE_BYTES)


class CommitOut(NamedTuple):
    """Outputs of one commit phase over a flat request array (Q = T*WS)."""
    table: VersionedTable
    granted: torch.Tensor       # bool  [Q]
    committed: torch.Tensor     # bool  [T]
    do_install: torch.Tensor    # bool  [Q]
    release_mask: torch.Tensor  # bool  [Q]
    fails: torch.Tensor         # int32 [T]


def _fail_counts(table: VersionedTable, req_slots, req_active, txn_of_req,
                 granted, n_txn: int):
    """Install feasibility and the per-transaction failure counts: a
    request is effective iff granted and its circular victim slot is
    reusable (§5.1); every active request that is not counts against its
    transaction. Returns ``(effective, fails int32 [n_txn])``."""
    R, K = table.n_records, table.n_old
    safe = gidx(torch.where(req_active, req_slots, 0), R)
    wpos = torch.remainder(table.next_write[safe].to(torch.int64), K)
    effective = granted & hdr_ops.is_moved(table.old_hdr[safe, wpos])
    # scatter-add with JAX's drop of out-of-range ids: slot n_txn is a sink
    fails = torch.zeros((n_txn + 1,), dtype=torch.int32,
                        device=req_active.device)
    fails.index_add_(0, sidx(txn_of_req, n_txn),
                     (req_active & ~effective).to(torch.int32))
    return effective, fails[:n_txn]


def decide_write_sets(table: VersionedTable, req_slots, req_expected,
                      req_prio, req_active, txn_of_req, n_txn: int):
    """The decide half of :func:`commit_write_sets`: its failure counts per
    transaction (int32 [n_txn]), computed without taking a lock or
    writing anything. A memory server's contribution to a cross-server
    commit decision (``store.distributed_round``)."""
    granted = cas.grant(table.cur_hdr, req_slots, req_expected, req_prio,
                        req_active)
    return _fail_counts(table, req_slots, req_active, txn_of_req, granted,
                        n_txn)[1]


def commit_write_sets(table: VersionedTable, req_slots, req_expected,
                      req_prio, req_active, txn_of_req, new_hdr, new_data,
                      txn_ok, *, ext_fails=None) -> CommitOut:
    """Phases 5/7/8 of Listing 1: arbitrated CAS validate + lock, install
    the write-sets of committed transactions, release the locks of aborted
    ones. A transaction commits iff ``txn_ok`` and none of its active
    requests (plus ``ext_fails``) failed. Updates ``table`` in place."""
    n_txn = txn_ok.shape[0]
    granted = anno.tag(cas.arbitrate(table.cur_hdr, req_slots, req_expected,
                                     req_prio, req_active).granted,
                       anno.LOCK_GRANTED)
    effective, fails = _fail_counts(table, req_slots, req_active, txn_of_req,
                                    granted, n_txn)
    total = fails if ext_fails is None else fails + ext_fails
    committed = anno.tag((total == 0) & txn_ok, anno.COMMIT_COMMITTED)

    txn_c = committed[gidx(txn_of_req, n_txn)]
    do_install = effective & txn_c
    mvcc.install(table, req_slots, new_hdr, new_data, do_install)
    release_mask = anno.tag(granted & ~txn_c, anno.LOCK_RELEASED)
    cas.release(table.cur_hdr, req_slots, release_mask)
    return CommitOut(table=table, granted=granted, committed=committed,
                     do_install=do_install, release_mask=release_mask,
                     fails=fails)


def run_round(table: VersionedTable, oracle: VectorOracle,
              state: VectorState, batch: TxnBatch, compute_fn: ComputeFn, *,
              rts_vec: Optional[torch.Tensor] = None, payload_bytes: int = 0,
              active: Optional[torch.Tensor] = None,
              directory: Optional[ht.HashTable] = None,
              keyed: Optional[KeyedReads] = None, dir_max_probes: int = 16,
              journal: Optional[wal.Journal] = None, journal_round=0,
              journal_seq=0, fused_commit: bool = False,
              batched_probe: bool = False) -> RoundResult:
    """Execute one batched round of the SI protocol.

    ``active`` (bool [T]) marks the threads that run a transaction.
    ``directory`` + ``keyed`` resolve the marked reads through the §5.2
    hash index; writes then validate and install at the resolved slots.
    ``batched_probe`` resolves the whole read-set with the
    ``kernels.hash_probe`` kernel and ``fused_commit`` runs the write side
    with the ``kernels.commit`` kernel; both are access-path choices with
    results identical to the plain rendering.

    ``journal`` switches the §6.2 WAL on: the intent records (T, resolved
    write slots, headers, payloads, effective write mask) are appended,
    stamped ``(journal_round, journal_seq)``, before either commit
    rendering runs, and the outcome records after the decision; both
    appends update the journal in place without waiting on the device.
    """
    T, RS = batch.read_slots.shape
    WS = batch.write_ref.shape[1]
    W = table.payload_width
    dev = batch.read_slots.device
    if active is None:
        active = torch.ones((T,), dtype=torch.bool, device=dev)

    # ---- 1. read timestamp (whole vector = the snapshot) -----------------
    if rts_vec is None:
        rts_vec = oracle.read(state)

    # ---- 2. key resolution (§5.2) + visible reads -------------------------
    flat_slots = batch.read_slots.reshape(-1)
    n_index_probes = 0
    if directory is not None:
        assert keyed is not None, "key-addressed mode needs KeyedReads"
        n_index_probes = (keyed.mask & batch.read_mask & active[:, None]).sum()
    if batched_probe:
        from repro_torch.kernels.hash_probe import ops as probe_ops
        if directory is not None:
            slot_out, f_out, src, pos = probe_ops.batched_probe(
                directory.keys, directory.vals, table, rts_vec, flat_slots,
                keyed.keys.reshape(-1), keyed.mask.reshape(-1),
                max_probes=dir_max_probes)
        else:
            slot_out, f_out, src, pos = probe_ops.batched_probe(
                None, None, table, rts_vec, flat_slots, None, None)
        flat_slots = torch.where(slot_out >= 0, slot_out, 0)
        hdr_flat, data_flat = mvcc.gather_version(
            table, flat_slots, mvcc.VersionLoc(found=f_out, src=src, pos=pos))
        read_found = f_out
        from_current = f_out & (src == mvcc.SRC_CURRENT)
        from_ovf = f_out & (src == mvcc.SRC_OVF)
    else:
        key_ok = torch.ones(flat_slots.shape, dtype=torch.bool, device=dev)
        if directory is not None:
            kvals, kfound = ht.lookup(directory, keyed.keys.reshape(-1),
                                      max_probes=dir_max_probes)
            km = keyed.mask.reshape(-1)
            flat_slots = torch.where(km, torch.where(kfound, kvals, 0),
                                     flat_slots)
            key_ok = ~km | kfound
        vr = mvcc.read_visible(table, flat_slots, rts_vec)
        hdr_flat, data_flat = vr.hdr, vr.data
        read_found = vr.found & key_ok
        from_current = vr.from_current & key_ok
        from_ovf = vr.from_ovf & key_ok
    read_slots = flat_slots.reshape(T, RS)
    read_hdr = hdr_flat.reshape(T, RS, 2)
    read_data = data_flat.reshape(T, RS, W)
    read_found = read_found.reshape(T, RS)
    from_current = from_current.reshape(T, RS)
    from_ovf = from_ovf.reshape(T, RS)
    txn_found = (read_found | ~batch.read_mask).all(dim=1)

    # ---- 3. transaction logic (local to the compute server) --------------
    new_data = compute_fn(read_hdr, read_data, rts_vec)
    assert new_data.shape == (T, WS, W), (new_data.shape, (T, WS, W))

    # ---- 4. commit timestamps, created locally ----------------------------
    slot = oracle.slot_of_thread(batch.tid)
    txn_ok = txn_found & active
    if hasattr(oracle, "next_commit_ts_batch"):
        cts = oracle.next_commit_ts_batch(state, batch.tid, txn_ok)
    else:
        cts = to_i32(u64(state.vec[gidx(slot, state.vec.shape[0])]) + 1)
    new_hdr = hdr_ops.pack(slot[:, None].expand(T, WS),
                           cts[:, None].expand(T, WS))

    # ---- 5. commit-phase request staging ----------------------------------
    wref = batch.write_ref.clamp(0, RS - 1).to(torch.int64)
    write_slots = read_slots.gather(1, wref)
    expected = read_hdr.gather(1, wref[:, :, None].expand(T, WS, 2))
    req_active = (batch.write_mask & txn_ok[:, None]).reshape(-1)
    req_slots = write_slots.reshape(-1)
    req_expected = expected.reshape(-1, 2)
    req_prio = batch.tid[:, None].expand(T, WS).reshape(-1)
    txn_of_req = torch.arange(T, dtype=torch.int32, device=dev)[:, None] \
        .expand(T, WS).reshape(-1)

    # ---- 6. the WAL intent records (§6.2), before install -----------------
    # they depend only on commit-phase inputs, so both commit renderings
    # log the same bytes
    if journal is not None:
        wal.append_intent(
            journal, batch.tid, rts_vec,
            *wal.pad_writes(journal, write_slots, new_hdr, new_data,
                            req_active.reshape(T, WS)),
            round_no=journal_round, seq=journal_seq)

    # ---- 5./7./8./9. validate+lock, install, release, make visible --------
    if fused_commit:
        # the kernel's in-launch scatter-max is the make-visible of the
        # vector oracles alone: any other oracle's make-visible runs
        # itself, and the kernel writes a scratch copy of the vector
        std_vis = type(oracle).make_visible is VectorOracle.make_visible
        from repro_torch.kernels.commit import ops as commit_ops
        fc = commit_ops.fused_commit(
            table, state.vec if std_vis else state.vec.clone(), req_slots,
            req_expected, req_prio, req_active, txn_of_req,
            new_hdr.reshape(-1, 2), new_data.reshape(-1, W), txn_ok, slot,
            cts, torch.zeros((T,), dtype=torch.int32, device=dev))
        granted = anno.tag(fc.granted, anno.LOCK_GRANTED)
        committed = anno.tag(fc.committed, anno.COMMIT_COMMITTED)
        do_install = fc.do_install
        release_mask = anno.tag(granted & ~committed[txn_of_req.to(
            torch.int64)], anno.LOCK_RELEASED)
        if not std_vis:
            oracle.make_visible(state, batch.tid, cts, committed)
    else:
        co = commit_write_sets(table, req_slots, req_expected, req_prio,
                               req_active, txn_of_req,
                               new_hdr.reshape(-1, 2),
                               new_data.reshape(-1, W), txn_ok)
        committed = co.committed
        do_install, release_mask = co.do_install, co.release_mask
        oracle.make_visible(state, batch.tid, cts, committed)
    # the outcome lands after the decision (§3.2: until then the
    # transaction is undetermined and its locks are the monitor's)
    if journal is not None:
        wal.append_outcome(journal, batch.tid, committed)

    # ---- op accounting -----------------------------------------------------
    ops = count_ops(oracle, batch, txn_found, from_current,
                    do_install.sum(), release_mask.sum(), committed.sum(), W,
                    payload_bytes, n_txns=active.sum(), active=active,
                    n_index_probes=n_index_probes)
    vis = vis_stats(batch.read_mask, read_found, from_current, from_ovf,
                    active)
    return RoundResult(table=table, oracle_state=state, committed=committed,
                       snapshot_miss=~txn_found, read_data=read_data, ops=ops,
                       vis=vis, journal=journal)


def run_rounds(table: VersionedTable, oracle, state, make_batch: Callable,
               compute_fn: ComputeFn, n_rounds: int, *, staleness: int = 0,
               fused_commit: bool = False, batched_probe: bool = False):
    """Driver: ``n_rounds`` rounds of :func:`run_round` over
    ``make_batch(round) -> TxnBatch``.

    ``staleness > 0`` emulates the §4.2 dedicated fetch thread: each round
    reads the vector made visible ``staleness`` rounds earlier (a ring of
    the last ``staleness + 1`` vectors, all the starting vector at first).
    The kernel flags are :func:`run_round`'s. Returns ``(table, state,
    committed bool [n_rounds, T], missed bool [n_rounds, T])``; the table
    and the oracle state are updated in place.
    """
    hist = state.vec.expand((max(1, staleness + 1),) + state.vec.shape) \
        .clone()
    committed, missed = [], []
    for r in range(n_rounds):
        out = run_round(table, oracle, state, make_batch(r), compute_fn,
                        rts_vec=hist[-1] if staleness > 0 else None,
                        fused_commit=fused_commit,
                        batched_probe=batched_probe)
        hist = torch.cat([out.oracle_state.vec[None], hist[:-1]])
        committed.append(out.committed)
        missed.append(out.snapshot_miss)
        table, state = out.table, out.oracle_state
    return table, state, torch.stack(committed), torch.stack(missed)
