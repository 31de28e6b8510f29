"""Wrapper of the CUDA paged decode attention kernel
(``csrc/paged_attention.cu``).

For tensors on the CPU :func:`paged_attention` runs its plain version
(:mod:`.ref`); for CUDA tensors it launches the kernel or raises — it never
falls back. Each call adds one to ``paged_attention.launches`` (a call is
one CUDA launch, or two when a sequence spans several partitions: the
partitions, then their merge); a call with no sequence or no head launches
nothing and counts nothing.

The kernel has no gradient: a CUDA call under autograd with an input
that requires one raises before it launches (``_cuda.refuse_grad``).

The kernel cuts each sequence into partitions of :func:`default_part`
pages (512 tokens' worth), one block
per (sequence, partition, K/V head, group of query heads), and merges the
partitions' softmax states in a second launch. The functions below give
the launch arithmetic that ``csrc/paged_attention.cu`` computes: the
partitions a table gives, the scratch they write, and the shared memory of
a block.

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

_ARGTYPES = [_cuda.P] * 7 + [_cuda.I] * 12 + [_cuda.F32, _cuda.F32]
HEAD_DIMS = (32, 64, 128, 256)
TILE_KEYS = 16      # keys a warp takes at once, two lanes a key
RING_STAGES = 3     # tiles in each warp's ring
PART_TOKENS = 512   # tokens a partition holds
MAX_PART = 512      # pages a partition at most (its page ids are staged)
_PAD = 16           # bytes after each K/V row in shared memory
_RING_BUDGET = 56 * 1024
_GRID_MAX = 2 ** 31 - 1


def group_size(g: int) -> int:
    """Query heads a block serves: the group of g heads sharing a K/V
    head, in blocks of at most 8."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def ring(D: int, itemsize: int):
    """``(warps, stages, stage_bytes)`` of a block: each warp streams its
    tiles of 16 K and 16 V rows (padded by 16 bytes) through its own ring
    of 3 stages, and a block has as many warps, 1 to 4, as fit 56 KB of
    rings (two at gemma2's D = 128 in bf16: four blocks an SM)."""
    stage = 2 * TILE_KEYS * (D * itemsize + _PAD)
    warps = max(1, min(4, _RING_BUDGET // (RING_STAGES * stage)))
    return warps, RING_STAGES, stage


def smem_bytes(D: int, g: int, itemsize: int, part: int) -> int:
    """Shared memory of a block of launch 1: the warps' rings, the scaled
    queries, the warps' probabilities and tile masks, and the partition's
    page ids."""
    warps, stages, stage = ring(D, itemsize)
    mg = group_size(g)
    return warps * stages * stage \
        + 4 * (mg * D + warps * TILE_KEYS * mg + warps * stages) + 4 * part


def default_part(ps: int) -> int:
    """Pages a partition holds: 512 tokens' worth (at least one page)."""
    return max(1, min(MAX_PART, PART_TOKENS // ps))


def partitions(n_pages: int, part: int) -> int:
    """Partitions of a table ``n_pages`` wide (one where it has none)."""
    return max(1, -(-n_pages // part))


def launch_points(D: int, g: int, itemsize: int, n_pages: int, ps: int):
    """The ``(function, threads, dynamic shared bytes)`` of launch 1, and
    of the merge where a table spans several partitions."""
    t = "__nv_bfloat16" if itemsize == 2 else "float"
    part = default_part(ps)
    points = [(f"paged_part_kernel<{t}, {D}, {group_size(g)}>",
               ring(D, itemsize)[0] * 32, smem_bytes(D, g, itemsize, part))]
    if partitions(n_pages, part) > 1:
        points.append((f"paged_merge_kernel<{t}>", D, 0))
    return tuple(points)


def scratch_bytes(B: int, Hq: int, D: int, n_part: int) -> int:
    """Float32 partials of launch 1, ``acc [B, Hq, n_part, D]`` and
    ``(m, l) [B, Hq, n_part, 2]``; none with one partition a sequence
    (launch 1 then writes the output)."""
    return 0 if n_part == 1 else 4 * B * Hq * n_part * (D + 2)


def blocks(B: int, Hkv: int, g: int, n_pages: int, part: int) -> int:
    """Blocks of launch 1, live or not: the grid is sized from the table's
    width, never from ``kv_len``."""
    return B * partitions(n_pages, part) * Hkv * -(-g // group_size(g))


def live_partitions(kv_len, n_pages: int, ps: int, part: int, window=None):
    """``(lo, hi)`` int64 tensors: the partitions ``[lo, hi)`` of each
    sequence that hold a visible token (``lo == hi`` where none does); the
    blocks of the others exit at once."""
    kl = kv_len.long()
    hi_tok = kl.clamp(max=n_pages * ps)
    lo_tok = torch.zeros_like(kl) if window is None \
        else (kl - int(window)).clamp(min=0)
    span = part * ps
    live = lo_tok < hi_tok
    lo = torch.where(live, lo_tok // span, 0)
    hi = torch.where(live, -(-hi_tok // span), 0)
    return lo, hi


def prepare(q, k_pool, v_pool, page_table, kv_len, *, window=None,
            softcap=None, scale=None):
    """Validate CUDA inputs of :func:`paged_attention` and allocate the
    output and the partitions' scratch; returns a function that launches
    the kernel and returns the output."""
    _cuda.refuse_grad("paged_attention", "common.decode_attention", q,
                      k_pool, v_pool)
    dev, code = _cuda.float_device("paged_attention", q)
    _cuda.check("paged_attention", dev, q.dtype, q=q, k_pool=k_pool,
                v_pool=v_pool)
    _cuda.check("paged_attention", dev, torch.int32, page_table=page_table,
                kv_len=kv_len)
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pool.shape
    n_pages = page_table.shape[1] if page_table.dim() == 2 else 0
    part = default_part(ps)
    g = Hq // Hkv if Hkv else 0
    if D not in HEAD_DIMS or Hkv == 0 or Hq % Hkv or P == 0 or ps == 0 \
            or v_pool.shape != k_pool.shape or k_pool.shape[3] != D \
            or page_table.dim() != 2 or page_table.shape[0] != B \
            or kv_len.shape != (B,) or Hkv > 65_535 \
            or P * ps > _GRID_MAX \
            or blocks(B, Hkv, g, n_pages, part) > _GRID_MAX:
        raise ValueError(
            f"paged_attention: unsupported shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}, page_table {tuple(page_table.shape)}, "
            f"kv_len {tuple(kv_len.shape)} (head dim one of {HEAD_DIMS}, Hq "
            f"a multiple of Hkv, a nonempty pool)")
    use_cap, cap = _cuda.softcap_args("paged_attention", softcap)
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    n_part = partitions(n_pages, part)
    scratch = torch.empty(scratch_bytes(B, Hq, D, n_part) // 4,
                          dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None, code, B, Hkv,
            g, D, P, ps, n_pages, part, *_cuda.window_args(window), use_cap,
            cap, float(scale))
    if B * Hq == 0:
        return lambda: out
    return functools.partial(
        _cuda.launch, _COUNTER, _cuda.entry("paged_attention", _ARGTYPES),
        args, dev, (q, k_pool, v_pool, page_table, kv_len, scratch), out,
        launch_points(D, g, q.element_size(), n_pages, ps))


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


_cuda.counted(paged_attention)
_COUNTER = paged_attention
