"""Timestamp oracles (paper §3.1 naive design and §4 scalable design).

Four designs, the four lines of the paper's Figure 6:

* :class:`GlobalCounterOracle`, the naive baseline (§3.1): one global
  commit counter taken with RDMA fetch-and-add, a ``ctsList`` bitmap of
  completed transactions, and a management thread that advances the read
  timestamp to the highest gap-free prefix. :class:`NaiveOracleAdapter`
  drives the SI engine with it.
* :class:`VectorOracle` (§4.1): the read timestamp is a vector ``T_R =
  ⟨t_1 … t_n⟩`` with one slot per transaction-execution thread. A commit
  timestamp is created locally (``t_i + 1``) and made visible by one
  unilateral write of slot ``i``; no atomics anywhere.
* :class:`CompressedVectorOracle` (§4.2): one slot per compute server,
  shared by its threads through a local fetch-and-add.
* :class:`PartitionedVectorOracle` (§4.2): the vector range-partitioned
  over the memory servers.

Timestamps, slots, the counter and the bitmap are uint32 words in int32
storage (``repro_torch._u32``). Every function updates its state **in
place** and returns it, and none waits on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._u32 import gidx, np_to_u32, sidx, to_i32, u64

_INT32_MIN = -(1 << 31)


# --------------------------------------------------------------------------
# Naive global-counter oracle (paper §3.1)
# --------------------------------------------------------------------------
class GlobalCounterState(NamedTuple):
    cts: torch.Tensor     # int32 [1] — the global commit counter
    rts: torch.Tensor     # int32 [1] — the global read timestamp
    bitmap: torch.Tensor  # int32 [capacity] — ctsList completion bits
    offset: torch.Tensor  # int32 [1] — bitmap origin (timestamp - offset)


class GlobalCounterOracle:
    """The naive design: one RDMA fetch-and-add counter and a ctsList scan."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity

    def init(self, device=None) -> GlobalCounterState:
        """Counter and read timestamp 0, an empty bitmap, timestamps from 1,
        on ``device`` (default ``cuda``; raises without one)."""
        dev = resolve_device(device)
        zero = lambda n: torch.zeros((n,), dtype=torch.int32, device=dev)
        return GlobalCounterState(cts=zero(1), rts=zero(1),
                                  bitmap=zero(self.capacity),
                                  offset=torch.ones((1,), dtype=torch.int32,
                                                    device=dev))

    def read(self, state: GlobalCounterState) -> torch.Tensor:
        """RDMA read of the global read timestamp (a 0-d copy)."""
        return state.rts[0].clone()

    def fetch_commit_ts(self, state: GlobalCounterState, n: int):
        """A round of ``n`` concurrent fetch-and-adds, serialised by the
        NIC: returns ``(state, cts [n])`` with ``cts = counter+1 …
        counter+n`` and the counter advanced by ``n`` (mod 2^32)."""
        base = u64(state.cts)
        ts = to_i32(base + torch.arange(1, n + 1, device=base.device))
        state.cts.copy_(to_i32(base + n))
        return state, ts

    def complete(self, state: GlobalCounterState, cts, committed=None):
        """Append outcomes to the ctsList: set the bit of every ``cts``,
        committed or aborted (the bit means "outcome known"). The index
        ``cts - offset`` wraps as a uint32, is read as an int32 (so it can
        be negative) and is clamped into the bitmap; the set is the
        reference's scatter-max of ones over uint32 words, under which a
        zero word becomes 1 and any other keeps its value."""
        del committed   # the outcome does not move the read timestamp
        idx = to_i32(u64(cts) - u64(state.offset[0])).to(torch.int64)
        idx = idx.clamp(0, self.capacity - 1)
        bits = state.bitmap[idx]
        state.bitmap[idx] = torch.where(bits == 0, 1, bits)
        return state

    def advance(self, state: GlobalCounterState):
        """The timestamp-management thread: ``rts = max(rts, offset - 1 +
        n_done)`` (mod 2^32), ``n_done`` the length of the bitmap's
        all-ones prefix. A hole stalls it for good, as in the paper."""
        prefix = torch.cumprod(state.bitmap, 0, dtype=torch.int32)
        n_done = u64(prefix).sum()
        new_rts = (u64(state.offset) - 1 + n_done) & 0xFFFFFFFF
        state.rts.copy_(to_i32(torch.maximum(u64(state.rts), new_rts)))
        return state


# --------------------------------------------------------------------------
# Timestamp-vector oracles (paper §4)
# --------------------------------------------------------------------------
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
        """The thread's slot plus one (a slot out of range once negatives
        wrap reads the clamped slot, as the reference's gather does)."""
        n = state.vec.shape[0]
        return to_i32(u64(state.vec[gidx(self.slot_of_thread(tid), n)]) + 1)

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


class CompressedVectorOracle(VectorOracle):
    """§4.2 compression: one slot per compute server of
    ``threads_per_server`` threads. Concurrent committers of one server in
    a round take consecutive timestamps above the slot, in thread order:
    the server's local fetch-and-add, rendered as a rank by prefix sum.
    Its make-visible is the vector's scatter-max."""

    def __init__(self, n_threads: int, threads_per_server: int):
        self.n_threads = n_threads
        self.threads_per_server = threads_per_server
        self.n_slots = max(1, n_threads // threads_per_server)

    def slot_of_thread(self, tid):
        return torch.as_tensor(tid) // self.threads_per_server

    def next_commit_ts_batch(self, state: VectorState, tids, want):
        """``cts [R]`` for the threads ``tids``: the slot's timestamp plus
        one plus the thread's rank among the wanting threads of its slot
        before it. A thread that does not want one and has no wanting
        thread before it has rank -1, so it gets the slot's timestamp
        itself; a slot out of range once negatives wrap has the rank
        -2^31 (the reference's gather fill) and reads the clamped slot."""
        n = self.n_slots
        slots = self.slot_of_thread(tids).to(torch.int64)
        one_hot = (slots[:, None] == torch.arange(n, device=slots.device)) \
            & torch.as_tensor(want, device=slots.device)[:, None]
        rank = one_hot.cumsum(0) - 1                            # [R, n]
        wrapped = torch.where(slots < 0, slots + n, slots)
        inside = (wrapped >= 0) & (wrapped < n)
        my_rank = torch.where(
            inside, rank.gather(1, wrapped.clamp(0, n - 1)[:, None])[:, 0],
            _INT32_MIN)
        return to_i32(u64(state.vec[gidx(slots, n)]) + 1 + my_rank)


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


class NaiveAdapterState(NamedTuple):
    vec: torch.Tensor          # int32 [1] — the advanced read timestamp
    gc: GlobalCounterState


class NaiveOracleAdapter:
    """The SI engine driven by the §3.1 naive design: the "vector" has one
    slot, the global read timestamp. Every thread of a round fetches a
    commit timestamp from the one counter (``counter+1+tid``, the NIC's
    order); making them visible takes the round's ``n_threads``
    fetch-and-adds, sets every outcome's ctsList bit and advances the read
    timestamp. Decisions equal the vector oracles' while the counter stays
    inside ``capacity``: the bitmap's origin never moves, so past it every
    index clamps to the last bit and the read timestamp stops at
    ``capacity`` for good."""

    def __init__(self, n_threads: int, capacity: int = 1 << 12):
        self.inner = GlobalCounterOracle(capacity)
        self.n_threads = n_threads
        self.n_slots = 1

    def init(self, device=None) -> NaiveAdapterState:
        g = self.inner.init(device)
        return NaiveAdapterState(vec=g.rts.clone(), gc=g)

    def slot_of_thread(self, tid):
        return torch.zeros_like(torch.as_tensor(tid))

    def read(self, state: NaiveAdapterState) -> torch.Tensor:
        return state.vec.clone()

    def next_commit_ts_batch(self, state: NaiveAdapterState, tids, want):
        """``counter + 1 + tid`` for every thread, wanted or not (an
        aborted or missing transaction fetched one too, and wastes it)."""
        del want
        return to_i32(u64(state.gc.cts[0]) + 1 + u64(torch.as_tensor(tids)))

    def make_visible(self, state: NaiveAdapterState, tid, cts,
                     committed=None):
        """The round's fetch-and-adds, the ctsList appends and the
        management thread's advance, in place; ``vec`` takes the new read
        timestamp."""
        g, _ = self.inner.fetch_commit_ts(state.gc, self.n_threads)
        self.inner.complete(g, cts, committed)
        self.inner.advance(g)
        state.vec.copy_(g.rts)
        return state


def staleness_window(vec_history: torch.Tensor, k: int) -> torch.Tensor:
    """§4.2 dedicated fetch thread: the vector prefetched ``k`` rounds ago
    (``vec_history`` [H, n_slots], row 0 the newest; ``k`` capped at H-1).
    Admissible under GSI: any committed snapshot may serve as a read
    snapshot."""
    return vec_history[min(k, vec_history.shape[0] - 1)]


def snapshot_summary(vec) -> np.uint64:
    """Exact scalar summary for logging and GC bookkeeping: the sum of the
    slots as uint64 on the host (a uint32 vector sums past 2^32 on long
    runs). Copies ``vec`` to the host: a logging helper, off the round."""
    return np_to_u32(vec.cpu().numpy()).astype(np.uint64).sum(
        dtype=np.uint64)
