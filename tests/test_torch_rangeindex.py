"""The port's range-index queries (``merge``, ``range_scan``,
``lookup_max_below``) against ``repro.core.rangeindex``.

Indexes are built and filled with numpy draws from a seed in both
packages, with key 0, keys at and past 2**31, duplicates, a delta buffer
filled to saturation and empty key ranges (an empty district of the order
index). Every output is an integer or a bool: equality is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rangeindex as jri

from repro_torch._u32 import np_to_i32
from repro_torch.core import rangeindex as ri

MAX_O = 1 << 14   # the order index's o_id space per district


def _t(a):
    return torch.from_numpy(np_to_i32(np.asarray(a)))


def _eq(ref, port, what=""):
    a = np_to_i32(np.asarray(ref))
    b = port.numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _eq_index(jidx, tidx):
    for f in tidx._fields:
        _eq(getattr(jidx, f), getattr(tidx, f), f)


def _keys(rng, n):
    """uint32 keys: order-index keys of a few districts, plus key 0, keys
    at and past 2**31, keys near 2**32 and duplicates."""
    d_key = rng.choice([0, 1, 3, 7, 131071], n)
    k = (d_key * MAX_O + rng.randint(0, 40, n)).astype(np.uint64)
    k[0] = rng.choice([0, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 3])
    k[1] = 0
    k[2] = k[3]                                       # duplicates
    return k.astype(np.uint32)


def _indexes(seed, n_base=20, capacity=32, delta_capacity=8, batches=3):
    """The same index in both packages: a bulk-loaded base, then masked
    insert batches that fill the delta to saturation."""
    rng = np.random.RandomState(seed)
    keys, vals = _keys(rng, n_base), rng.randint(0, 1000, n_base)
    vals = vals.astype(np.int32)
    jidx = jri.build(jnp.asarray(keys), jnp.asarray(vals), capacity,
                     delta_capacity)
    tidx = ri.build(_t(keys), _t(vals), capacity, delta_capacity)
    for _ in range(batches):
        k, v = _keys(rng, 6), rng.randint(0, 1000, 6).astype(np.int32)
        m = rng.rand(6) < 0.8
        jidx = jri.insert(jidx, jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(m))
        tidx = ri.insert(tidx, _t(k), _t(v), torch.from_numpy(m))
    _eq_index(jidx, tidx)
    assert int(tidx.delta_used) == delta_capacity   # the delta is full
    return rng, jidx, tidx


def _bounds(rng, n):
    """Query bounds: every district's range (most empty), the whole space,
    bounds at 0, 1, 2**31 and 2**32 - 1, and random words."""
    d = np.array([0, 1, 2, 3, 5, 7, 131071, 131072], np.uint64)
    lo = np.concatenate([d * MAX_O, [0, 0, 1, 2**31, 2**31 - 1, 2**32 - 4],
                         rng.randint(0, 2**32, n, dtype=np.uint64)])
    hi = np.concatenate([(d + 1) * MAX_O, [2**32 - 1, 1, 2**31, 2**31 + 6,
                                           2**31, 2**32 - 1],
                         rng.randint(0, 2**32, n, dtype=np.uint64)])
    return lo.astype(np.uint32), hi.astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_matches_reference(seed):
    _, jidx, tidx = _indexes(seed)
    _eq_index(jri.merge(jidx), ri.merge(tidx))


@pytest.mark.parametrize("seed,max_results", [(0, 8), (1, 4), (2, 20)])
def test_range_scan_matches_reference(seed, max_results):
    rng, jidx, tidx = _indexes(seed)
    lo, hi = _bounds(rng, 10)
    for jx, tx in ((jidx, tidx), (jri.merge(jidx), ri.merge(tidx))):
        ref = jri.range_scan(jx, jnp.asarray(lo), jnp.asarray(hi),
                             max_results=max_results)
        port = ri.range_scan(tx, _t(lo), _t(hi), max_results=max_results)
        for name, a, b in zip(("keys", "vals", "count"), ref, port):
            _eq(a, b, name)
        count = port[2].numpy()
        assert (count == 0).any() and (count > 0).any()
    # a scalar bound scans one range, as the reference's atleast_1d does
    _eq(jri.range_scan(jidx, jnp.uint32(0), jnp.uint32(MAX_O), 4)[0],
        ri.range_scan(tidx, 0, MAX_O, 4)[0], "scalar bounds")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookup_max_below_matches_reference(seed):
    """Key 0 qualifies below 1 (ranked by key + 1), and an empty range or a
    bound at 0 reports not found."""
    rng, jidx, tidx = _indexes(seed)
    lo, hi = _bounds(rng, 10)
    for bound in (hi, lo):
        for jx, tx in ((jidx, tidx), (jri.merge(jidx), ri.merge(tidx))):
            ref = jri.lookup_max_below(jx, jnp.asarray(bound))
            port = ri.lookup_max_below(tx, _t(bound))
            for name, a, b in zip(("key", "val", "found"), ref, port):
                _eq(a, b, name)
    k, _, found = ri.lookup_max_below(tidx, _t(np.array([1, 0], np.uint32)))
    assert found.tolist() == [True, False] and int(k[0]) == 0
