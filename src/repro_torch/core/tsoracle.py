"""The timestamp-vector oracle (paper §4.1).

The read timestamp is a vector ``T_R = ⟨t_1 … t_n⟩`` with one slot per
transaction-execution thread. A commit timestamp is created locally
(``t_i + 1``) and made visible by one unilateral write of slot ``i``; no
atomics anywhere. Slots are uint32 words in int32 storage.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch._u32 import sidx, to_i32, u64


class VectorState(NamedTuple):
    vec: torch.Tensor  # int32 [n_slots] — T_R (uint32 words)


class VectorOracle:
    """One slot per transaction-execution thread; ``slot_of_thread`` is
    the identity."""

    def __init__(self, n_threads: int):
        self.n_threads = n_threads
        self.n_slots = n_threads

    def init(self, device=None) -> VectorState:
        """Zero vector on ``device`` (default ``cuda``; raises without one)."""
        return VectorState(vec=torch.zeros(
            (self.n_slots,), dtype=torch.int32, device=resolve_device(device)))

    def slot_of_thread(self, tid):
        return tid

    def read(self, state: VectorState) -> torch.Tensor:
        """One-sided read of the whole vector: a snapshot (a copy)."""
        return state.vec.clone()

    def next_commit_ts(self, state: VectorState, tid):
        return to_i32(u64(state.vec[self.slot_of_thread(tid)]) + 1)

    def make_visible(self, state: VectorState, tid, cts, committed=None):
        """Scatter-max of the commit timestamps into the threads' slots,
        masked to the committed transactions; a slot out of range once
        negatives wrap is dropped. Updates ``state.vec`` in place and
        returns ``state``."""
        cts = u64(cts)
        if committed is not None:
            cts = torch.where(committed, cts, 0)
        n = state.vec.shape[0]
        vec = torch.cat([u64(state.vec), cts.new_zeros(1)])   # n is a sink
        vec.scatter_reduce_(0, sidx(self.slot_of_thread(tid), n), cts, "amax")
        state.vec.copy_(to_i32(vec[:n]))
        return state


class PartitionedVectorOracle(VectorOracle):
    """§4.2 partitioning: T_R split into ``n_parts`` contiguous parts of
    ``part_size`` slots over the memory servers. For one reader the vector
    semantics do not change; :func:`read_partitioned` models reading the
    parts at different staleness, and ``part_of_slot`` names the server of
    a slot (``store.distributed_round(shard_vector=True)``)."""

    def __init__(self, n_threads: int, n_parts: int):
        super().__init__(n_threads)
        self.n_parts = n_parts
        self.part_size = -(-n_threads // n_parts)

    def part_of_slot(self, slot):
        return torch.as_tensor(slot) // self.part_size

    def read_partitioned(self, states, round_of_part):
        """Each part read at its own staleness (GSI-admissible):
        ``states`` is a history of vectors [H, n_slots], ``round_of_part``
        int [n_parts] an index into it per part."""
        slots = torch.arange(self.n_slots, device=states.device)
        part = self.part_of_slot(slots)
        return states[round_of_part.to(torch.int64)[part], slots]
