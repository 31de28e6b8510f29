"""Wrapper of the CUDA selective scan kernel (``csrc/mamba_scan.cu``).

For tensors on the CPU :func:`mamba_scan` runs its plain version
(:mod:`.ref`); for CUDA tensors it launches the kernel or raises — it never
falls back. Each launch adds one to ``mamba_scan.launches``; a call with
no step or no channel launches nothing and counts nothing.

The kernel has no gradient: a CUDA call under autograd with an input
that requires one raises before it launches (``_cuda.refuse_grad``).

The kernel copies 16 bytes at a time and its state count is a template
constant (8, 16, 32 or 64), so the wrapper pads what does not fit: B, C
and A_log with zero states up to that count (a zero B and C keep such a
state at 0 and out of y), S with zero steps up to a multiple of the staged
chunk (dt = 0 there, so a = 1 and b = 0: the state is left as it is), and
Di with zero channels up to whole 16-byte copies (their y is dropped). The
functions below give the launch arithmetic the kernel computes.

With ``return_state`` the kernel also writes each channel's float32 state
after its last step, the state a decode cache carries on from; the padded
steps leave it as it was after step S, and the wrapper drops the padded
channels' and states' entries.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _cuda
from repro_torch.kernels.mamba_scan import ref

_ARGTYPES = [_cuda.P] * 8 + [_cuda.I] * 7
MAX_STATE = 64
STATES = (8, 16, 32, 64)    # the kernel's state counts
LANES = 2                   # lanes that share a channel's states
RING_STAGES = 3             # chunks in shared memory at once
MAX_CHUNK = 64
MAX_THREADS = 256


def state_width(N: int) -> int:
    """The kernel's state count for N states: the next of ``STATES``."""
    return next(w for w in STATES if w >= N)


def block_channels(bd, Di: int, itemsize: int = 2) -> int:
    """Channels a block: ``bd`` (default 128 threads' worth), at most Di,
    rounded up so that a block is whole warps and a step's channels whole
    16-byte copies, at most ``MAX_THREADS`` threads."""
    step = max(32 // LANES, 16 // itemsize)
    bd = MAX_THREADS // 2 // LANES if bd is None else bd
    bd = -(-min(max(bd, 1), Di) // step) * step
    return min(bd, MAX_THREADS // LANES)


def smem_bytes(N: int, chunk: int, bd: int, itemsize: int) -> int:
    """Shared memory of a block: the ring's stages of dt and x (``bd``
    channels) and of B and C (the padded states) and two chunks of y, in
    the inputs' dtype, and two chunks of B and C widened to float32."""
    n = state_width(N)
    return (RING_STAGES * 2 * chunk * (bd + n) + 2 * chunk * bd) * itemsize \
        + 4 * 4 * chunk * n


def chunk_steps(chunk: int, N: int, bd: int, itemsize: int) -> int:
    """Steps a stage holds: ``chunk``, at most ``MAX_CHUNK``, and no more
    than let a block's shared memory fit."""
    chunk = min(max(chunk, 1), MAX_CHUNK)
    while chunk > 1 and smem_bytes(N, chunk, bd, itemsize) > _cuda.MAX_SMEM:
        chunk //= 2
    return chunk


def launch_shape(B: int, Di: int, bd=None, itemsize: int = 2):
    """``(blocks, threads a block)`` of a launch."""
    bd = block_channels(bd, Di, itemsize)
    return B * -(-Di // bd), bd * LANES


def launch_points(N: int, bd: int, chunk: int, itemsize: int):
    """The ``(function, threads, dynamic shared bytes)`` of a launch of
    ``bd`` channels a block (:func:`block_channels`) and stages of
    ``chunk`` steps (:func:`chunk_steps`)."""
    t = "__nv_bfloat16" if itemsize == 2 else "float"
    return ((f"scan_kernel<{t}, {state_width(N)}>", bd * LANES,
             smem_bytes(N, chunk, bd, itemsize)),)


def _aligned(t):
    """``t``, or a copy of it whose data starts on a 16-byte boundary (the
    kernel's 16-byte copies need one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def prepare(dt, x, Bm, Cm, A_log, D_skip, *, bd=None, chunk: int = 64,
            return_state=False):
    """Validate CUDA inputs of :func:`mamba_scan`, pad states, steps and
    channels as the module says and allocate the outputs; returns a
    function that launches the kernel and returns ``y [B, S, Di]`` (with
    ``return_state``, ``(y, h_last [B, Di, N])``)."""
    _cuda.refuse_grad("mamba_scan", "mamba_scan_ref", dt, x, Bm, Cm, A_log,
                      D_skip)
    dev, code = _cuda.float_device("mamba_scan", x)
    _cuda.check("mamba_scan", dev, x.dtype, dt=dt, x=x, Bm=Bm, Cm=Cm)
    _cuda.check("mamba_scan", dev, torch.float32, A_log=A_log, D_skip=D_skip)
    B, S, Di = x.shape
    N = Bm.shape[2]
    if dt.shape != x.shape or Bm.shape != (B, S, N) or Cm.shape != Bm.shape \
            or A_log.shape != (Di, N) or D_skip.shape != (Di,) \
            or N > MAX_STATE or B > 65_535 or (bd is not None and bd < 1) \
            or chunk < 1:
        raise ValueError(
            f"mamba_scan: unsupported shapes dt {tuple(dt.shape)}, x "
            f"{tuple(x.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, "
            f"A_log {tuple(A_log.shape)}, D_skip {tuple(D_skip.shape)} "
            f"(N ≤ {MAX_STATE}), bd {bd}, chunk {chunk}")
    if B * S * Di == 0:
        y = torch.empty_like(x)
        out = (y, torch.zeros((B, Di, N), dtype=torch.float32,
                              device=dev)) if return_state else y
        return lambda: out
    item = x.element_size()
    bd = block_channels(bd, Di, item)
    chunk = chunk_steps(chunk, N, bd, item)
    pad_s, pad_d = (-S) % chunk, (-Di) % (16 // item)
    Nw = state_width(N)
    if pad_s or pad_d:
        dt, x = (F.pad(t, (0, pad_d, 0, pad_s)) for t in (dt, x))
        D_skip = F.pad(D_skip, (0, pad_d))
    if pad_s or Nw > N:
        Bm, Cm = (F.pad(t, (0, Nw - N, 0, pad_s)) for t in (Bm, Cm))
    if Nw > N or pad_d:
        A_log = F.pad(A_log, (0, Nw - N, 0, pad_d))
    dt, x, Bm, Cm = (_aligned(t) for t in (dt, x, Bm, Cm))
    y = torch.empty_like(x)
    out = y[:, :S, :Di]
    h_ptr = None
    if return_state:
        h_last = torch.empty((B, Di + pad_d, Nw), dtype=torch.float32,
                             device=dev)
        h_ptr = h_last.data_ptr()
        out = (out, h_last[:, :Di, :N])
    args = (dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A_log.data_ptr(), D_skip.data_ptr(), y.data_ptr(), h_ptr, code,
            B, S + pad_s, Di + pad_d, Nw, bd, chunk)
    return functools.partial(
        _cuda.launch, _COUNTER, _cuda.entry("mamba_scan", _ARGTYPES), args,
        dev, (dt, x, Bm, Cm, A_log, D_skip), out,
        launch_points(N, bd, chunk, item))


# analysis: safe(K5): h0 is the plain decode from a cache; prefill is h0=None
def mamba_scan(dt, x, Bm, Cm, A_log, D_skip, *, bd=None, chunk: int = 64,
               return_state=False):
    """dt, x: [B, S, Di]; Bm, Cm: [B, S, N] (one dtype); A_log: [Di, N]
    and D_skip: [Di], float32. Returns y: [B, S, Di] in x's dtype; with
    ``return_state``, ``(y, h_last)``, h_last [B, Di, N] the float32 state
    after the last step (zero for S = 0).

    Two lanes share a channel's states, ``bd`` channels make a block
    (:func:`block_channels`) and ``chunk`` steps are staged at a time
    (:func:`chunk_steps`); neither changes the result. At jamba width
    (B·Di = 16,384 channels) two lanes give each of an SM's four
    schedulers two warps; on the H100 they ran faster than one lane (one
    warp a scheduler) and than four (more of a step's work besides the
    states): PERF.md §6."""
    if x.device.type == "cpu":
        return ref.mamba_scan_ref(dt, x, Bm, Cm, A_log, D_skip,
                                  return_state=return_state)
    return prepare(dt, x, Bm, Cm, A_log, D_skip, bd=bd, chunk=chunk,
                   return_state=return_state)()


_cuda.counted(mamba_scan)
_COUNTER = mamba_scan
