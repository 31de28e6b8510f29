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
