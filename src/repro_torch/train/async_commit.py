"""Timestamp-vector asynchronous data parallelism
(``repro/train/async_commit.py``): the paper's §4 commit vector applied to
training.

Worker group ``i`` publishes its update by bumping slot ``i`` of a commit
vector, with no global barrier; a worker reads the freshest snapshot in
which no slot lags more than ``staleness_bound`` commits behind its own
count (bounded-staleness SGD: a slow group cannot stall the read
frontier), and a checkpoint reads a dedicated snapshot of the vector
(paper §6.2). This is the single-program form the reference's tests use.

``vec`` is an int32 tensor holding the reference's uint32 counters (the
port's convention, ``_u32.py``): increments wrap as uint32's do, and the
lag is the wrapping int32 difference, as the reference's
``astype(int32)`` takes it. ``deltas`` is a tree like the parameters,
each leaf float32 with a leading ``n_groups`` axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._tree import leaves, tmap


class CommitVectorState(NamedTuple):
    vec: torch.Tensor   # int32 [n_groups]: uint32 commit counters
    deltas: object      # tree: the last committed update of each group


def init(n_groups: int, param_tree) -> CommitVectorState:
    return CommitVectorState(
        vec=torch.zeros((n_groups,), dtype=torch.int32,
                        device=leaves(param_tree)[0].device),
        deltas=tmap(lambda p: torch.zeros((n_groups,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), param_tree))


def commit(state: CommitVectorState, group: int, update
           ) -> CommitVectorState:
    """Group ``group`` publishes ``update`` and bumps its own slot: one
    unilateral write, no atomics, no barrier (paper §4.1)."""
    def put(d, u):
        d = d.clone()
        d[group] = u.float()
        return d
    vec = state.vec.clone()
    vec[group] += 1
    return CommitVectorState(vec=vec, deltas=tmap(put, state.deltas,
                                                  update))


def read_frontier(state: CommitVectorState, my_count) -> torch.Tensor:
    """How far each slot lags ``my_count`` (an int, or an int32 tensor of
    a uint32 count): the wrapping int32 difference."""
    mine = torch.as_tensor(my_count, device=state.vec.device)
    if mine.dtype != torch.int32:
        mine = (mine.to(torch.int64) & 0xFFFFFFFF).to(torch.int32)
    return mine - state.vec


def can_proceed(state: CommitVectorState, my_count,
                staleness_bound: int) -> torch.Tensor:
    """Bounded staleness: proceed iff no slot lags more than the bound
    (0: synchronous data parallelism)."""
    return read_frontier(state, my_count).max() <= staleness_bound


def snapshot_combine(state: CommitVectorState, base_params, weights=None):
    """The parameters of the snapshot: base plus the weighted sum of the
    groups' deltas (by default their mean), in each base leaf's dtype."""
    n = state.vec.shape[0]
    if weights is None:
        weights = torch.ones((n,), dtype=torch.float32,
                             device=state.vec.device) / n

    def combine(p, d):
        avg = torch.tensordot(weights, d, dims=1)
        return (p.float() + avg).to(p.dtype)
    return tmap(combine, base_params, state.deltas)


def straggler_mask(state: CommitVectorState, my_count, bound: int):
    """Groups beyond the staleness bound (candidates for eviction)."""
    return read_frontier(state, my_count) > bound
