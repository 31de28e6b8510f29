"""Locality as an optimization, not a requirement (paper §2.2, §7.3).

Placement maps (which memory server owns which slot range), the two Fig. 5
routing policies, and the local-access fraction of an access trace. Nothing
in the protocol changes: locality only flips per-op costs in the model.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Placement(NamedTuple):
    """Range partitioning of the unified pool over memory servers."""
    n_servers: int
    shard_records: int

    def server_of_slot(self, slots):
        return torch.as_tensor(slots).to(torch.int32) // self.shard_records


def moved_slots(old: Placement, new: Placement, n_records: int, *,
                device=None) -> torch.Tensor:
    """Which pool slots change owning server between two placements: the
    record-migration set of an online scale-out, bool [n_records]."""
    s = torch.arange(n_records, dtype=torch.int32, device=device)
    return old.server_of_slot(s) != new.server_of_slot(s)


def co_located_server(tid, threads_per_server: int):
    """Compute server hosting thread ``tid`` (one pair per machine, §7.1)."""
    return torch.as_tensor(tid).to(torch.int32) // threads_per_server


def local_fraction(placement: Placement, txn_server, access_slots,
                   access_mask) -> torch.Tensor:
    """Fraction of record accesses that hit the executing machine's memory
    (float32, as the reference divides): ``txn_server`` int32 [T],
    ``access_slots`` int32 [T, A], ``access_mask`` bool [T, A]."""
    owner = placement.server_of_slot(access_slots)
    local = (owner == txn_server[:, None]) & access_mask
    total = access_mask.sum().clamp(min=1)
    return local.sum().to(torch.float32) / total.to(torch.float32)


def route_home(home_warehouse, warehouses_per_server: int):
    """§7.3 "w/ locality": run a transaction where its home warehouse
    lives."""
    return torch.as_tensor(home_warehouse).to(torch.int32) \
        // warehouses_per_server


def thread_homes(n_threads: int, n_warehouses: int, *, device=None):
    """TPC-C terminal model: threads pinned round-robin to home warehouses."""
    return torch.arange(n_threads, dtype=torch.int32,
                        device=device) % n_warehouses


def route_transactions(mode: str, placement: Placement, home_slot, tid,
                       n_threads: int):
    """The two Fig. 5 deployments as routing policies: ``"aware"`` runs a
    transaction on the server owning its home district record,
    ``"oblivious"`` pins threads to servers round-robin. Returns the
    executing server per transaction, int32 [T]."""
    if mode == "aware":
        return placement.server_of_slot(home_slot)
    if mode == "oblivious":
        return co_located_server(
            tid, max(1, -(-n_threads // placement.n_servers)))
    raise ValueError(f"unknown locality mode: {mode!r}")


def expected_local_fraction(distributed_pct: float,
                            items_remote_when_distributed: float = 1.0,
                            accesses_home: float = 13.0,
                            accesses_remote: float = 10.0) -> float:
    """The reference's analytic expectation of the local share of TPC-C
    new-order at a degree of distribution: a distributed new-order sources
    its ~10 stocks remotely instead of at home (``accesses_remote`` does
    not enter, as in the reference)."""
    d = distributed_pct / 100.0
    local = accesses_home - d * items_remote_when_distributed * 10.0
    return max(0.0, local / accesses_home)
