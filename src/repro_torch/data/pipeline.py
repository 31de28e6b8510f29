"""Synthetic serving prompts (``repro/data/pipeline.py``: ``make_prompts``
only; ``make_batch`` waits for slice F3, training)."""
from __future__ import annotations

import numpy as np


def make_prompts(seed: int, n: int, vocab: int, min_len: int = 4,
                 max_len: int = 12):
    """Random prompts for the serving examples and benchmarks: ``n`` int32
    arrays of ``min_len..max_len`` tokens in ``[2, vocab)``. ``seed`` takes
    the place of the reference's JAX key: the reference seeds numpy with
    ``int(jax.random.randint(key, (), 0, 2**31 - 1))``, so that integer
    here gives the same prompts."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n)
    return [rng.integers(2, vocab, size=l).astype(np.int32) for l in lens]
