"""Range index — the B+-tree analogue (paper §5.2).

A bulk-loaded sorted base array plus a small sorted delta buffer for
inserts. Keys are uint32 words in int32 storage; sorting widens them so the
``SENTINEL`` padding (0xFFFFFFFF, -1 as int32) sorts last.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._u32 import MASK32, i32, to_i32, u64

SENTINEL = i32(0xFFFFFFFF)


class RangeIndex(NamedTuple):
    base_keys: torch.Tensor   # int32 [N] sorted; SENTINEL padding at tail
    base_vals: torch.Tensor   # int32 [N]
    delta_keys: torch.Tensor  # int32 [D] sorted; SENTINEL padding
    delta_vals: torch.Tensor  # int32 [D]
    delta_used: torch.Tensor  # int32 []


def _sorted(keys, vals):
    order = torch.sort(u64(keys), stable=True).indices
    return keys[order], vals[order]


def build(keys, vals, capacity: int, delta_capacity: int = 256) -> RangeIndex:
    dev = keys.device
    n = keys.shape[0]
    sk, sv = _sorted(keys.to(torch.int32), vals.to(torch.int32))
    bk = torch.full((capacity,), SENTINEL, dtype=torch.int32, device=dev)
    bv = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    bk[:n], bv[:n] = sk, sv
    return RangeIndex(
        base_keys=bk, base_vals=bv,
        delta_keys=torch.full((delta_capacity,), SENTINEL, dtype=torch.int32,
                              device=dev),
        delta_vals=torch.full((delta_capacity,), -1, dtype=torch.int32,
                              device=dev),
        delta_used=torch.zeros((), dtype=torch.int32, device=dev))


def insert(idx: RangeIndex, keys, vals, mask=None) -> RangeIndex:
    """Append into the delta buffer and keep it sorted. The buffer keeps
    its D smallest keys: past D entries it saturates (no merge here)."""
    keys, vals = keys.to(torch.int32), vals.to(torch.int32)
    if mask is not None:
        keys = torch.where(mask, keys, SENTINEL)
        vals = torch.where(mask, vals, -1)
    dk, dv = _sorted(torch.cat([idx.delta_keys, keys]),
                     torch.cat([idx.delta_vals, vals]))
    D = idx.delta_keys.shape[0]
    used = idx.delta_used + (keys != SENTINEL).sum().to(torch.int32)
    return idx._replace(delta_keys=dk[:D], delta_vals=dv[:D],
                        delta_used=torch.clamp(used, max=D))


def merge(idx: RangeIndex) -> RangeIndex:
    """Fold the delta into the base (compaction): the N smallest keys of
    base ∪ delta become the base, the delta empties."""
    N = idx.base_keys.shape[0]
    bk, bv = _sorted(torch.cat([idx.base_keys, idx.delta_keys]),
                     torch.cat([idx.base_vals, idx.delta_vals]))
    return idx._replace(
        base_keys=bk[:N], base_vals=bv[:N],
        delta_keys=torch.full_like(idx.delta_keys, SENTINEL),
        delta_vals=torch.full_like(idx.delta_vals, -1),
        delta_used=torch.zeros_like(idx.delta_used))


def _search(keys, q):
    """``searchsorted`` (left) of uint32 words ``q`` [Q] in sorted ``keys``."""
    return torch.searchsorted(u64(keys), u64(q))


def range_scan(idx: RangeIndex, lo, hi, max_results: int):
    """All (key, val) with ``lo <= key < hi`` from base ∪ delta, batched
    over queries ``lo``/``hi`` [Q] (uint32 words).

    Returns ``(keys int32 [Q, max_results], vals int32 [...], count int32
    [Q])``, key-sorted per query with ``SENTINEL``/-1 padding.
    """
    lo = torch.atleast_1d(torch.as_tensor(lo)).to(torch.int32)
    hi = torch.atleast_1d(torch.as_tensor(hi)).to(torch.int32)
    lo64, hi64 = u64(lo)[:, None], u64(hi)[:, None]
    offs = torch.arange(max_results, device=lo.device)
    picks_k, picks_v = [], []
    for keys, vals in ((idx.base_keys, idx.base_vals),
                       (idx.delta_keys, idx.delta_vals)):
        pos = (_search(keys, lo)[:, None] + offs).clamp(0, keys.shape[0] - 1)
        k = keys[pos]
        ok = (u64(k) >= lo64) & (u64(k) < hi64)
        picks_k.append(torch.where(ok, k, SENTINEL))
        picks_v.append(torch.where(ok, vals[pos], -1))
    k, v = torch.cat(picks_k, dim=1), torch.cat(picks_v, dim=1)
    order = torch.sort(u64(k), dim=1, stable=True).indices[:, :max_results]
    k, v = k.gather(1, order), v.gather(1, order)
    return k, v, (k != SENTINEL).sum(dim=1).to(torch.int32)


def lookup_max_below(idx: RangeIndex, hi):
    """Largest key ``< hi`` per query ``hi`` [Q] (uint32 words): returns
    ``(key int32 [Q], val int32 [Q], found bool [Q])``; key 0 and val -1
    where nothing qualifies."""
    hi = torch.atleast_1d(torch.as_tensor(hi)).to(torch.int32)
    hi64 = u64(hi)
    ks, vs, oks = [], [], []
    for keys, vals in ((idx.base_keys, idx.base_vals),
                       (idx.delta_keys, idx.delta_vals)):
        s = _search(keys, hi)
        pos = (s - 1).clamp(0, keys.shape[0] - 1)
        k = keys[pos]
        ok = (u64(k) < hi64) & (k != SENTINEL) & (s > 0)
        ks.append(torch.where(ok, k, 0))
        vs.append(torch.where(ok, vals[pos], -1))
        oks.append(ok)
    k, v, ok = torch.stack(ks, 1), torch.stack(vs, 1), torch.stack(oks, 1)
    # rank by key+1 so a qualifying key 0 still beats the non-qualifying
    # candidates at rank 0; argmax takes the first of equal ranks
    best = torch.where(ok, u64(k) + 1, 0).argmax(dim=1, keepdim=True)
    return k.gather(1, best)[:, 0], v.gather(1, best)[:, 0], ok.any(dim=1)


def partition_bounds(n_servers: int, key_space: int, *, device=None):
    """Range partitioning of the key space over memory servers (§5.2):
    ``(lo, hi)`` uint32 words [n_servers], each part ``ceil(key_space /
    n_servers)`` keys wide, in the reference's uint32 arithmetic."""
    per = -(-key_space // n_servers)
    lo = torch.arange(n_servers, dtype=torch.int64, device=device) * per
    hi = torch.clamp((lo + per) & MASK32, max=key_space)
    return to_i32(lo), to_i32(hi)
