"""Wrapper of the CUDA grouped expert FFN kernel (``csrc/moe_gmm.cu``).

For tensors on the CPU :func:`moe_gmm` runs its plain version (:mod:`.ref`);
for CUDA tensors it launches the kernel or raises — it never falls back.
Each call that launches adds one to ``moe_gmm.launches`` (the kernel is two
CUDA launches on one stream: gate/up, then down); a call with no expert,
row or model dimension launches nothing and counts nothing.

The kernel has no gradient: a CUDA call under autograd with an input
that requires one raises before it launches (``_cuda.refuse_grad``).

The kernel has two routes, chosen by dtype. bfloat16 runs on the tensor
cores (128 × 128 tiles, K staged 64 at a time by TMA through a four-stage
ring: :func:`tc_smem_bytes`) and carries ``a·h`` between its launches as two
bf16 planes, ``hi`` and ``lo``; it needs D and F to be multiples of 8
(:func:`check_alignment`). float32 runs on the FMA units with a float32
``a·h``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

_ARGTYPES = [_cuda.P] * 6 + [_cuda.I] * 8
ACTIVATIONS = {"silu": 0, "gelu": 1, "sq_relu": 2}
TC_TILE = (128, 128, 64)   # bf16 route: rows, columns and depth of a tile
TC_STAGES = 4              # and the depth of its shared-memory ring
_ALIGN = 8                 # bf16 values in 16 bytes: TMA's row alignment
_ATOM = 1024               # a 128-byte swizzle atom (8 rows), wgmma's
DOWN = 3                   # moe_gmm.cu's mode of the down product
TC_THREADS = 2 * 128 + 32  # bf16 route: two consumer warpgroups, a producer
THREADS = 256              # float32 route (moe_gmm.cu THREADS)


def tc_smem_bytes(activation: str, down: bool) -> int:
    """Shared memory of one bf16 block of the gate/up launch (``down``
    False) or the down launch: a full and an empty mbarrier per stage, one
    swizzle atom of slack to align the ring, and per stage an x tile (two,
    the hi and lo planes, when down) and a weight tile for each product it
    stages (w_gate and w_in; w_in alone for ``sq_relu``; w_out), bf16 as
    TMA writes them."""
    bm, bn, bk = TC_TILE
    n_a = 2 if down else 1
    n_b = 1 if down or activation == "sq_relu" else 2
    return 2 * TC_STAGES * 8 + _ATOM \
        + TC_STAGES * 2 * (n_a * bm * bk + n_b * bk * bn)


def launch_points(activation: str, bf16: bool):
    """The ``(function, threads, dynamic shared bytes)`` of a launch's
    gate/up product and its down product."""
    modes = (ACTIVATIONS[activation], DOWN)
    if not bf16:
        return tuple((f"gmm_kernel<{m}>", THREADS, 0) for m in modes)
    return tuple((f"gmm_tc_kernel<{m}>", TC_THREADS,
                  tc_smem_bytes(activation, m == DOWN)) for m in modes)


def check_alignment(D: int, F: int) -> None:
    """Raise unless every row of x, the weights and ``a·h`` is a whole
    number of 16-byte units, as the bf16 route's TMA tensor maps need: D
    and F multiples of 8."""
    if D % _ALIGN or F % _ALIGN:
        raise ValueError(f"moe_gmm: the bfloat16 kernel needs D and F to be "
                         f"multiples of {_ALIGN}, got D={D}, F={F}")


def prepare(x, w_gate, w_in, w_out, *, activation: str = "silu"):
    """Validate CUDA inputs of :func:`moe_gmm` and allocate the output and
    the ``a·h`` scratch (bf16: the hi and lo planes ``[2, E, C, F]``;
    float32: ``[E, C, F]``); returns a function that launches the kernel
    and returns the output."""
    _cuda.refuse_grad("moe_gmm", "moe.apply_moe's einsums", x, w_gate, w_in,
                      w_out)
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
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        check_alignment(D, F)
        ah = torch.empty((2, E, C, F), dtype=torch.bfloat16, device=dev)
    else:
        ah = torch.empty((E, C, F), dtype=torch.float32, device=dev)
    points = launch_points(activation, bf16)
    smem = tuple(p[2] for p in points)
    args = (x.data_ptr(), w_gate.data_ptr(), w_in.data_ptr(),
            w_out.data_ptr(), ah.data_ptr(), out.data_ptr(), code, E, C, D,
            F, ACTIVATIONS[activation], *smem)
    if E * C * D == 0:
        return lambda: out
    return functools.partial(
        _cuda.launch, _COUNTER, _cuda.entry("moe_gmm", _ARGTYPES), args, dev,
        (x, w_gate, w_in, w_out, ah), out, points)


def moe_gmm(x, w_gate, w_in, w_out, *, activation: str = "silu"):
    """x: [E, C, D]; w_gate/w_in: [E, D, F]; w_out: [E, F, D] → [E, C, D]:
    per expert ``(act(x @ w_gate) * (x @ w_in)) @ w_out`` (``sq_relu``:
    ``relu(x @ w_in)^2 @ w_out``), float32 inside, x's dtype out."""
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w_gate, w_in, w_out, activation=activation)
    return prepare(x, w_gate, w_in, w_out, activation=activation)()


_cuda.counted(moe_gmm)
_COUNTER = moe_gmm
