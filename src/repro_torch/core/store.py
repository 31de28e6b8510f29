"""The NAM store on one memory server (paper §2.1, §5): the unified
versioned record pool, the timestamp-vector oracle state and the extend
allocator for inserts (§5.3), plus the §5.2 directory loader."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashtable as ht, header as hdr_ops, mvcc
from repro_torch.core.catalog import Catalog
from repro_torch.core.mvcc import VersionedTable
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
