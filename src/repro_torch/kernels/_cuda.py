"""What the kernels' wrappers share: binding a kernel's C entry with
``ctypes``, checking their CUDA inputs, refusing a call that needs a
gradient, and launching with a count.

Every C entry takes the CUDA stream as its last argument and returns the
CUDA error of its launch (0 when it launched, or had nothing to launch).
A wrapper's count lives on the original wrapper object, so it stays
reachable when a caller rebinds the module's name. So does its
``launched``: how often each kernel function ran at each block shape,
which the K3 check on the card reads (``analysis/kernel_audit.py``).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build

P, I, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float
# the element types the float kernels take, by their code in csrc
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# dynamic shared memory one block can have on sm_90 (227 KB)
MAX_SMEM = 232_448
_INT_MAX = 2 ** 31 - 1


def entry(name: str, argtypes):
    """The C entry ``<name>_launch`` of kernel ``name``, built and loaded
    at first use; ``argtypes`` exclude the stream."""
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [*argtypes, P], ctypes.c_int
    return fn


def check(kernel: str, dev, dtype, **tensors) -> None:
    """Raise unless every tensor is contiguous, on ``dev`` and of ``dtype``
    (a dtype or a tuple of them)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    for name, t in tensors.items():
        if t.device != dev or t.dtype not in dtypes \
                or not t.is_contiguous():
            want = " or ".join(str(d) for d in dtypes)
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {want} tensor on "
                f"{dev}, got {t.dtype} on {t.device}"
                + ("" if t.is_contiguous() else ", not contiguous"))


def refuse_grad(kernel: str, plain: str, *tensors) -> None:
    """Raise, before anything launches, when autograd is on and an input
    requires a gradient: no kernel has a backward pass, and the output it
    writes carries no ``grad_fn``, so the graph would be cut silently.
    ``plain`` names the plain path that differentiates."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no gradient, and an input "
            f"requires one (its output would cut the autograd graph); "
            f"differentiate the plain path, {plain}, as "
            f"transformer.train_loss does (kernels=False), or call the "
            f"kernel under torch.no_grad()")


def float_device(kernel: str, t: torch.Tensor):
    """The CUDA device and dtype code of ``t``, the kernel's first float
    input; raises on any other device or dtype."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    if t.dtype not in DTYPES:
        raise ValueError(f"{kernel}: takes float32 or bfloat16, got "
                         f"{t.dtype}")
    return t.device, DTYPES[t.dtype]


def window_args(window):
    """``(use, width)`` of an optional attention window, as C ints."""
    if window is None:
        return 0, 0
    return 1, max(min(int(window), _INT_MAX), -_INT_MAX)


def softcap_args(kernel: str, softcap):
    """``(use, cap)`` of an optional logit softcap; raises unless it is
    positive."""
    if softcap is None:
        return 0, 0.0
    if softcap <= 0:
        raise ValueError(f"{kernel}: softcap must be positive, got "
                         f"{softcap}")
    return 1, float(softcap)


def counted(wrapper):
    """Give ``wrapper`` its count of launches and its ``launched``."""
    wrapper.launches = 0
    wrapper.launched = collections.Counter()


def launch(wrapper, fn, args, dev, held, out, points):
    """Launch ``fn(*args)`` on the current stream of ``dev`` and count it
    on ``wrapper``; ``held`` keeps every tensor the arguments point at
    alive until the launch is enqueued. ``points`` are the ``(function,
    threads a block, dynamic shared bytes a block)`` of each kernel
    function the C entry runs, as ``cu++filt`` names it without its
    namespace; they are added to ``wrapper.launched``. Returns ``out``."""
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    wrapper.launches += 1
    wrapper.launched.update(points)
    del held
    return out
