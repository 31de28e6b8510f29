"""RDMA-friendly hash table (paper §5.2, after Pilaf [31]).

Open addressing with linear probing. Keys are uint32 stored ``+1`` so 0 is
the empty bucket; values are int32 record slots. Keys live as int32 words
(``repro_torch._u32``); the Fibonacci hash widens them to compute
``key * 2654435769 mod 2**32`` exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._u32 import mul_u32, rows_of, to_i32, u64

EMPTY = 0
_NO_RANK = 1 << 62


class HashTable(NamedTuple):
    keys: torch.Tensor  # int32 [B] — stored key+1 (uint32 words); 0 = empty
    vals: torch.Tensor  # int32 [B]

    @property
    def n_buckets(self) -> int:
        return self.keys.shape[0]


def init(n_buckets: int, *, device) -> HashTable:
    return HashTable(
        keys=torch.zeros((n_buckets,), dtype=torch.int32, device=device),
        vals=torch.full((n_buckets,), -1, dtype=torch.int32, device=device))


def _hash(key, n_buckets):
    """Fibonacci hashing of uint32 keys, as int64 bucket indices."""
    return mul_u32(key, 2654435769) % n_buckets


def _key1(keys):
    return to_i32(u64(keys) + 1)


def lookup(ht: HashTable, keys, max_probes: int = 16):
    """Batched get. Returns (vals int32 [Q], found bool [Q]).

    An entry invalidated by a delete (``val < 0``) ends the probe but
    reports ``found=False``; ``vals`` then carries its raw value.
    """
    keys1 = _key1(keys)
    base = _hash(keys, ht.n_buckets)
    B = ht.n_buckets
    vals = torch.full(keys1.shape, -1, dtype=torch.int32, device=keys1.device)
    found = torch.zeros(keys1.shape, dtype=torch.bool, device=keys1.device)
    done = torch.zeros_like(found)
    for p in range(max_probes):
        idx = (base + p) % B
        k = ht.keys[idx]
        key_hit = ~done & (k == keys1)
        empty = ~done & (k == EMPTY)
        v = ht.vals[idx]
        vals = torch.where(key_hit, v, vals)
        found = found | (key_hit & (v >= 0))
        done = done | key_hit | empty
    return vals, found


def insert(ht: HashTable, keys, vals, mask=None, max_probes: int = 16):
    """Batched put with tournament arbitration per bucket.

    Each probe round every unresolved inserter bids for its probe bucket;
    the lowest-rank bidder whose bucket is empty (or holds its key) wins;
    losers advance. Returns ``(new_ht, placed_at int32 [Q])`` with -1 where
    the probe bound ran out. The input table is not modified.
    """
    Q = keys.shape[0]
    dev = keys.device
    keys1 = _key1(keys)
    vals = vals.to(torch.int32)
    open_ = torch.ones((Q,), dtype=torch.bool, device=dev) if mask is None \
        else mask.clone()
    base = _hash(keys, ht.n_buckets)
    B = ht.n_buckets
    rank = torch.arange(Q, device=dev)
    tkeys, tvals = ht.keys.clone(), ht.vals.clone()
    placed = torch.full((Q,), -1, dtype=torch.int32, device=dev)
    for p in range(max_probes):
        idx = (base + p) % B
        cur = tkeys[idx]
        can = open_ & ((cur == EMPTY) | (cur == keys1))
        # tournament: lowest rank per bucket among the claimants; bucket B
        # is a sink for the lanes that do not bid
        arb = torch.full((B + 1,), _NO_RANK, dtype=torch.int64, device=dev)
        arb.scatter_reduce_(0, torch.where(can, idx, B), rank, "amin")
        win = can & (arb[idx] == rank)
        w = rows_of(win)
        tkeys[idx[w]] = keys1[w]
        tvals[idx[w]] = vals[w]
        placed = torch.where(win, idx.to(torch.int32), placed)
        open_ = open_ & ~win
    return HashTable(keys=tkeys, vals=tvals), placed
