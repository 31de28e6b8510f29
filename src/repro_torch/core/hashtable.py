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


def lookup_shard(shard_keys, shard_vals, queries, base, n_buckets_total: int,
                 max_probes: int = 16):
    """The memory servers' contributions to a partitioned lookup (§5.2).

    The bucket array is range-partitioned over the servers like the record
    pool: a server holds buckets ``[base, base + count)`` of the global
    array. Every server walks the same global probe sequence over its
    resident buckets; the sum of the contributions over the servers is
    :func:`lookup`: ``key_hit`` is their OR, ``val`` their sum (a stored
    key sits in one bucket, so one server contributes at most), ``found =
    key_hit & val >= 0``, and the caller maps no hit to ``val = -1``. The
    scan runs all ``max_probes`` positions without stopping at an empty
    bucket, and still finds what :func:`lookup` finds: an insert claims the
    first empty-or-same-key bucket and :func:`delete` only invalidates
    values, so no stored key sits beyond an empty bucket of its chain.

    ``shard_keys``/``shard_vals`` [count] with an int ``base`` give one
    server's ``(val_contrib int32 [Q], key_hit bool [Q])``; stacked
    ``[S, count]`` with ``S`` bases give every server's at once, ``[S, Q]``.
    """
    stacked = shard_keys.dim() == 2
    skeys = shard_keys if stacked else shard_keys[None]
    svals = shard_vals if stacked else shard_vals[None]
    count = skeys.shape[1]
    dev = queries.device
    base = torch.as_tensor(base, dtype=torch.int64, device=dev).reshape(-1, 1)
    rows = torch.arange(skeys.shape[0], device=dev)[:, None]
    keys1 = _key1(queries)
    home = _hash(queries, n_buckets_total)
    vals = torch.zeros((skeys.shape[0],) + keys1.shape, dtype=torch.int32,
                       device=dev)
    hit = torch.zeros(vals.shape, dtype=torch.bool, device=dev)
    for p in range(max_probes):
        loc = (home + p)[None, :] % n_buckets_total - base
        inside = (loc >= 0) & (loc < count)
        safe = torch.where(inside, loc, 0)
        here = inside & (skeys[rows, safe] == keys1) & ~hit
        vals = torch.where(here, svals[rows, safe], vals)
        hit = hit | here
    vals = torch.where(hit, vals, 0)
    return (vals, hit) if stacked else (vals[0], hit[0])


def delete(ht: HashTable, keys, max_probes: int = 16):
    """Invalidate the entries of ``keys``: NAM-DB marks the record deleted
    and keeps its directory key (a tombstone-free delete would break linear
    probing), so only the value becomes -1. Returns ``(new_ht, found
    bool [Q])``, ``found`` as :func:`lookup` saw it before; the input table
    is not modified."""
    _, found = lookup(ht, keys, max_probes)
    keys1 = _key1(keys)
    base = _hash(keys, ht.n_buckets)
    B = ht.n_buckets
    tvals = torch.cat([ht.vals, ht.vals.new_zeros(1)])   # B is a sink
    done = torch.zeros(keys1.shape, dtype=torch.bool, device=keys1.device)
    for p in range(max_probes):
        idx = (base + p) % B
        hit = ~done & (ht.keys[idx] == keys1)
        tvals.scatter_(0, torch.where(hit, idx, B), -1)
        done = done | hit
    return ht._replace(vals=tvals[:B]), found


def partition_of(keys, n_buckets: int, n_servers: int):
    """The memory server owning each key's home bucket (range
    partitioning), int64 [Q]."""
    return _hash(keys, n_buckets) // -(-n_buckets // n_servers)


def moved_buckets(n_buckets: int, old_servers: int, new_servers: int, *,
                  device=None) -> torch.Tensor:
    """Which directory buckets change owning server when the mesh grows
    (the bucket analogue of ``locality.moved_slots``), bool [n_buckets]."""
    b = torch.arange(n_buckets, device=device)
    return b // -(-n_buckets // old_servers) != b // -(-n_buckets
                                                        // new_servers)
