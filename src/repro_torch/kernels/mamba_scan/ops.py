"""Wrapper of the CUDA selective scan kernel (``csrc/mamba_scan.cu``).

For tensors on the CPU :func:`mamba_scan` runs its plain version
(:mod:`.ref`); for CUDA tensors it launches the kernel or raises — it never
falls back. Each launch adds one to ``mamba_scan.launches``; a call with
no step or no channel launches nothing and counts nothing.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _cuda
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

_ARGTYPES = [_cuda.P] * 7 + [_cuda.I] * 7
MAX_STATE = 64


def prepare(dt, x, Bm, Cm, A_log, D_skip, *, bd: int = 128,
            chunk: int = 16):
    """Validate CUDA inputs of :func:`mamba_scan`, pad S to a multiple of
    ``chunk`` (dt = 0 there, so a = 1 and b = 0: the state is left as it
    is) and allocate the output; returns a function that launches the
    kernel and returns ``y [B, S, Di]``."""
    dev, code = _cuda.float_device("mamba_scan", x)
    _cuda.check("mamba_scan", dev, x.dtype, dt=dt, x=x, Bm=Bm, Cm=Cm)
    _cuda.check("mamba_scan", dev, torch.float32, A_log=A_log, D_skip=D_skip)
    B, S, Di = x.shape
    N = Bm.shape[2]
    if dt.shape != x.shape or Bm.shape != (B, S, N) or Cm.shape != Bm.shape \
            or A_log.shape != (Di, N) or D_skip.shape != (Di,) \
            or N > MAX_STATE or B > 65_535 or bd < 1 or chunk < 1:
        raise ValueError(
            f"mamba_scan: unsupported shapes dt {tuple(dt.shape)}, x "
            f"{tuple(x.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, "
            f"A_log {tuple(A_log.shape)}, D_skip {tuple(D_skip.shape)} "
            f"(N ≤ {MAX_STATE}), bd {bd}, chunk {chunk}")
    pad = (-S) % chunk
    if pad:
        dt, x, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, x, Bm, Cm))
    bd = min(bd, Di, 1024)
    y = torch.empty_like(x)
    args = (dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A_log.data_ptr(), D_skip.data_ptr(), y.data_ptr(), code, B,
            S + pad, Di, N, bd, chunk)
    if B * S * Di == 0:
        return lambda: y[:, :S]
    return functools.partial(
        _cuda.launch, _COUNTER, _cuda.entry("mamba_scan", _ARGTYPES), args,
        dev, (dt, x, Bm, Cm, A_log, D_skip), y[:, :S])


def mamba_scan(dt, x, Bm, Cm, A_log, D_skip, *, bd: int = 128,
               chunk: int = 16):
    """dt, x: [B, S, Di]; Bm, Cm: [B, S, N] (one dtype); A_log: [Di, N]
    and D_skip: [Di], float32. Returns y: [B, S, Di] in x's dtype.

    ``bd`` channels share a block (one thread each) and ``chunk`` steps are
    staged at a time; neither changes the result. The reference's default
    ``bd`` of 256 would leave half the card idle at B·Di = 16k, hence
    128."""
    if x.device.type == "cpu":
        return mamba_scan_ref(dt, x, Bm, Cm, A_log, D_skip)
    return prepare(dt, x, Bm, Cm, A_log, D_skip, bd=bd, chunk=chunk)()


mamba_scan.launches = 0
_COUNTER = mamba_scan
