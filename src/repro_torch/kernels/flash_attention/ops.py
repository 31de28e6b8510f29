"""Wrapper of the CUDA flash attention kernel (``csrc/flash_attention.cu``).

For tensors on the CPU :func:`flash_attention` runs its plain version
(:mod:`.ref`); for CUDA tensors it launches the kernel or raises — it never
falls back. Each launch adds one to ``flash_attention.launches``; a call
with no query row launches nothing and counts nothing. :func:`prepare`
validates and folds the inputs once and returns the launch, so a caller
can repeat it on the same buffers.

The kernel has no gradient: a CUDA call under autograd with an input
that requires one raises before it launches (``_cuda.refuse_grad``).

The kernel has two routes, chosen by dtype: bfloat16 runs on the tensor
cores with its own tiles (:func:`tc_tiles`, :func:`tc_smem_bytes`), and
float32 on the FMA units with the tiles :func:`tile_sizes` picks from
``bq`` and ``bk``.

On a query row that sees no key (a window with Sq > Sk + window - 1) the
kernel returns 0; the plain version, like the reference, returns an
average of every key there. Every other row agrees.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_ARGTYPES = [_cuda.P] * 4 + [_cuda.I, _cuda.I64] + [_cuda.I] * 8 \
    + [_cuda.F32, _cuda.F32] + [_cuda.I] * 3
HEAD_DIMS = (32, 64, 128, 256)
_ROWS, _KEYS = 8, 32   # float32 route: query rows per warp, keys per sub-tile
TC_BQ, TC_STAGES = 128, 3  # bf16 route: query rows per block, K/V ring depth
_ATOM = 1024                # a 128-byte swizzle atom (8 rows), wgmma's
TC_THREADS = 2 * 128 + 32   # bf16 route: two consumer warpgroups, a producer


def tc_tiles(D: int):
    """The bf16 route's query rows per block and keys per stage: 128 rows
    (two warpgroups of 64) and 64 keys, 32 at D = 256 so that the
    accumulators of 64 rows by 256 dimensions leave registers for the
    scores."""
    return TC_BQ, 64 if D <= 128 else 32


def tc_smem_bytes(D: int) -> int:
    """Shared memory of one bf16 block: the mbarriers (Q's, and a full K,
    a full V and an empty one per stage), one swizzle atom of slack to
    align the tiles, the query tile, and the K and V rings of
    ``TC_STAGES`` tiles, bf16 as TMA writes them."""
    bq, bk = tc_tiles(D)
    return 8 * (1 + 3 * TC_STAGES) + _ATOM \
        + 2 * D * (bq + 2 * TC_STAGES * bk)


def tc_points(D: int):
    """The ``(function, threads, dynamic shared bytes)`` of a bf16
    launch."""
    return ((f"flash_tc_kernel<{D}>", TC_THREADS, tc_smem_bytes(D)),)


def smem_bytes(bq: int, bk: int, D: int) -> int:
    """Shared memory of one float32 block: the scaled query tile, the
    padded K and the V stage, and the warps' probabilities, all float32."""
    return 4 * (bq * D + bk * (D + 4) + bk * D + bq * _KEYS)


def tile_sizes(bq: int, bk: int, Sq: int, Sk: int, D: int):
    """The float32 route's query rows per block (a multiple of 8, at most
    128) and keys per stage (a multiple of 32) nearest below ``bq`` and
    ``bk`` that the shapes need and one block's shared memory holds."""
    up = lambda n, m: -(-max(n, 1) // m) * m  # noqa: E731
    bq = max(_ROWS, min(bq, 128, up(Sq, _ROWS)) // _ROWS * _ROWS)
    bk = max(_KEYS, min(bk, up(Sk, _KEYS)) // _KEYS * _KEYS)
    while smem_bytes(bq, bk, D) > _cuda.MAX_SMEM:
        if bk > _KEYS:
            bk = max(_KEYS, bk // 2 // _KEYS * _KEYS)
        else:
            bq = max(_ROWS, bq // 2 // _ROWS * _ROWS)
    return bq, bk


def prepare(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
            bq=128, bk=128):
    """Validate CUDA inputs of :func:`flash_attention`, fold them to
    ``[B·H, S, D]`` and allocate the output; returns a function that
    launches the kernel and returns the folded output ``[B·Hq, Sq, D]``."""
    _cuda.refuse_grad("flash_attention", "common.chunked_attention", q, k,
                      v)
    dev, code = _cuda.float_device("flash_attention", q)
    _cuda.check("flash_attention", dev, q.dtype, q=q, k=k, v=v)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if D not in HEAD_DIMS or Hkv == 0 or Hq % Hkv or k.shape != v.shape \
            or k.shape[0] != B or k.shape[3] != D or B * Hq > 65_535:
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} (head dim one of {HEAD_DIMS}, "
                         f"Hq a multiple of Hkv, B·Hq ≤ 65535)")
    use_cap, cap = _cuda.softcap_args("flash_attention", softcap)
    scale = D ** -0.5 if scale is None else scale
    qf = q.transpose(1, 2).reshape(B * Hq, Sq, D).contiguous()
    kf = k.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    vf = v.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    out = torch.empty_like(qf)
    if q.dtype == torch.bfloat16:
        bq, bk = tc_tiles(D)
        points = tc_points(D)
    else:
        bq, bk = tile_sizes(bq, bk, Sq, Sk, D)
        points = ((f"flash_kernel<{D}>", bq // _ROWS * 32,
                   smem_bytes(bq, bk, D)),)
    smem = points[0][2]
    args = (qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
            code, B * Hq, Sq, Sk, D, Hq // Hkv, int(causal),
            *_cuda.window_args(window), use_cap, cap, float(scale), bq, bk,
            smem)
    if B * Hq * Sq == 0:
        return lambda: out
    return functools.partial(
        _cuda.launch, _COUNTER,
        _cuda.entry("flash_attention", _ARGTYPES), args, dev,
        (qf, kf, vf), out, points)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, bq=128, bk=128):
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] → [B, Sq, Hq, D].

    Head h attends K/V head h // (Hq // Hkv). On the float32 route ``bq``
    query rows share a block and ``bk`` keys are staged at a time (both
    shrink to what the shapes need and shared memory holds); the bf16
    route uses its own tile (:func:`tc_tiles`). Neither changes the
    result."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    B, Sq, Hq, D = q.shape
    of = prepare(q, k, v, causal=causal, window=window, softcap=softcap,
                 scale=scale, bq=bq, bk=bk)()
    return of.reshape(B, Hq, Sq, D).transpose(1, 2)


_cuda.counted(flash_attention)
_COUNTER = flash_attention
