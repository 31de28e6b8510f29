"""Range index — the B+-tree analogue (paper §5.2).

A bulk-loaded sorted base array plus a small sorted delta buffer for
inserts. Keys are uint32 words in int32 storage; sorting widens them so the
``SENTINEL`` padding (0xFFFFFFFF, -1 as int32) sorts last.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._u32 import i32, u64

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
