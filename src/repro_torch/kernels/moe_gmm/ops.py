"""Wrapper of the CUDA grouped expert FFN kernel (``csrc/moe_gmm.cu``).

For tensors on the CPU :func:`moe_gmm` runs its plain version (:mod:`.ref`);
for CUDA tensors it launches the kernel or raises — it never falls back.
Each call that launches adds one to ``moe_gmm.launches`` (the kernel is two
CUDA launches on one stream: gate/up, then down); a call with no expert,
row or model dimension launches nothing and counts nothing.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

_ARGTYPES = [_cuda.P] * 6 + [_cuda.I] * 6
ACTIVATIONS = {"silu": 0, "gelu": 1, "sq_relu": 2}


def prepare(x, w_gate, w_in, w_out, *, activation: str = "silu"):
    """Validate CUDA inputs of :func:`moe_gmm` and allocate the output and
    the float32 ``a·h`` scratch ``[E, C, F]``; returns a function that
    launches the kernel and returns the output."""
    dev, code = _cuda.float_device("moe_gmm", x)
    _cuda.check("moe_gmm", dev, x.dtype, x=x, w_gate=w_gate, w_in=w_in,
                w_out=w_out)
    if activation not in ACTIVATIONS:
        raise ValueError(f"moe_gmm: unknown activation {activation!r}")
    E, C, D = x.shape
    F = w_in.shape[2]
    if w_gate.shape != (E, D, F) or w_in.shape != (E, D, F) \
            or w_out.shape != (E, F, D) or E > 65_535:
        raise ValueError(f"moe_gmm: unsupported shapes x {tuple(x.shape)}, "
                         f"w_gate {tuple(w_gate.shape)}, w_in "
                         f"{tuple(w_in.shape)}, w_out {tuple(w_out.shape)}")
    out = torch.empty_like(x)
    ah = torch.empty((E, C, F), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), w_gate.data_ptr(), w_in.data_ptr(),
            w_out.data_ptr(), ah.data_ptr(), out.data_ptr(), code, E, C, D,
            F, ACTIVATIONS[activation])
    if E * C * D == 0:
        return lambda: out
    return functools.partial(
        _cuda.launch, _COUNTER, _cuda.entry("moe_gmm", _ARGTYPES), args, dev,
        (x, w_gate, w_in, w_out, ah), out)


def moe_gmm(x, w_gate, w_in, w_out, *, activation: str = "silu"):
    """x: [E, C, D]; w_gate/w_in: [E, D, F]; w_out: [E, F, D] → [E, C, D]:
    per expert ``(act(x @ w_gate) * (x @ w_in)) @ w_out`` (``sq_relu``:
    ``relu(x @ w_in)^2 @ w_out``), float32 inside, x's dtype out."""
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w_gate, w_in, w_out, activation=activation)
    return prepare(x, w_gate, w_in, w_out, activation=activation)()


moe_gmm.launches = 0
_COUNTER = moe_gmm
