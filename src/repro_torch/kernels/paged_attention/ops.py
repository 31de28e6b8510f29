"""Wrapper of the CUDA paged decode attention kernel
(``csrc/paged_attention.cu``).

For tensors on the CPU :func:`paged_attention` runs its plain version
(:mod:`.ref`); for CUDA tensors it launches the kernel or raises — it never
falls back. Each launch adds one to ``paged_attention.launches``; a call
with no sequence or no head launches nothing and counts nothing.

The kernel follows the reference's TPU kernel where that differs from the
plain version: it skips an unmapped page even below ``kv_len`` (the plain
version reads zeros there and weighs them), and a sequence with
``kv_len = 0`` gets 0 (the plain version averages its gathered rows).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_ARGTYPES = [_cuda.P] * 6 + [_cuda.I] * 11 + [_cuda.F32, _cuda.F32]
HEAD_DIMS = (32, 64, 128, 256)


def prepare(q, k_pool, v_pool, page_table, kv_len, *, window=None,
            softcap=None, scale=None):
    """Validate CUDA inputs of :func:`paged_attention` and allocate the
    output; returns a function that launches the kernel and returns it."""
    dev, code = _cuda.float_device("paged_attention", q)
    _cuda.check("paged_attention", dev, q.dtype, q=q, k_pool=k_pool,
                v_pool=v_pool)
    _cuda.check("paged_attention", dev, torch.int32, page_table=page_table,
                kv_len=kv_len)
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pool.shape
    if D not in HEAD_DIMS or Hkv == 0 or Hq % Hkv or P == 0 or ps == 0 \
            or v_pool.shape != k_pool.shape or k_pool.shape[3] != D \
            or page_table.dim() != 2 or page_table.shape[0] != B \
            or kv_len.shape != (B,) or Hkv > 65_535:
        raise ValueError(
            f"paged_attention: unsupported shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, page_table {tuple(page_table.shape)}, "
            f"kv_len {tuple(kv_len.shape)} (head dim one of {HEAD_DIMS}, Hq "
            f"a multiple of Hkv, a nonempty pool)")
    use_cap, cap = _cuda.softcap_args("paged_attention", softcap)
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), code,
            B, Hkv, Hq // Hkv, D, P, ps, page_table.shape[1],
            *_cuda.window_args(window), use_cap, cap, float(scale))
    if B * Hq == 0:
        return lambda: out
    return functools.partial(
        _cuda.launch, _COUNTER, _cuda.entry("paged_attention", _ARGTYPES),
        args, dev, (q, k_pool, v_pool, page_table, kv_len), out)


def paged_attention(q, k_pool, v_pool, page_table, kv_len, *, window=None,
                    softcap=None, scale=None):
    """q: [B, Hq, D]; k/v_pool: [P, ps, Hkv, D]; page_table: [B, n_pages]
    int32 (-1 = unmapped); kv_len: [B] int32 tokens already in the pool.
    Returns [B, Hq, D]."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, kv_len,
                                   window=window, softcap=softcap,
                                   scale=scale)
    return prepare(q, k_pool, v_pool, page_table, kv_len, window=window,
                   softcap=softcap, scale=scale)()


paged_attention.launches = 0
_COUNTER = paged_attention
