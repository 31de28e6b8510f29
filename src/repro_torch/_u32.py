"""Word and index conventions shared by every module of the port.

**uint32 words.** Headers, timestamp vectors and directory keys are uint32
in the protocol. PyTorch's ``uint32`` lacks shifts, ordered comparisons,
sums, modulo, ``index_put_`` and ``scatter_reduce``, so the port stores each
such word as an ``int32`` tensor holding the uint32 bit pattern. Equality
and the bitwise operators work on the pattern as it is; anything that needs
the unsigned value (``<=``, ``>>``, ``+``, ``%``, min/max) widens first with
:func:`u64` and narrows back with :func:`to_i32`. The CUDA kernels
reinterpret the same storage as ``uint32_t``.

**Index semantics.** The port reproduces what JAX does with a bad index
instead of raising as PyTorch would: a gather wraps negative indices once and
then clamps into range (:func:`gidx`); a scatter wraps negative indices once
and then **drops** what is still out of range, so its index goes to a sink
row ``n`` (:func:`sidx`) or the scatter is written only at the rows its mask
selects (:func:`rows_of`). A clamped index never feeds a scatter.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_HALF = 1 << 31
_FULL = 1 << 32


def u64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of a uint32 bit pattern, as int64."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Narrow an int64 value to the int32 tensor holding its low 32 bits."""
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= _HALF, x - _FULL, x).to(torch.int32)


def i32(v: int) -> int:
    """The int32 bit pattern of a Python uint32 constant."""
    v &= MASK32
    return v - _FULL if v >= _HALF else v


def mul_u32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` of a uint32 value ``x`` (int64 in, int64 out).

    The product of two words overflows int64, so the multiply is split
    into 16-bit halves of ``x``; every partial product stays below 2**48.
    """
    x = u64(x)
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & MASK32


def gidx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX gather semantics: negative indices wrap once, then clamp."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)


def sidx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX scatter semantics: negative indices wrap once; an index still
    out of range becomes ``n``, a sink row the caller drops."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def rows_of(mask: torch.Tensor) -> torch.Tensor:
    """Positions where ``mask`` holds — the rows a dropping scatter writes."""
    return mask.nonzero().squeeze(1)


def np_to_i32(a) -> np.ndarray:
    """A numpy array with uint32 lanes viewed as the port's int32 words."""
    a = np.asarray(a).copy(order="C")
    return a.view(np.int32) if a.dtype == np.uint32 else a


def np_to_u32(a: np.ndarray) -> np.ndarray:
    """The inverse view of :func:`np_to_i32` for uint32 fields."""
    return np.asarray(a).copy(order="C").view(np.uint32)
