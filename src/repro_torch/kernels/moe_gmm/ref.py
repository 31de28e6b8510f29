"""Plain PyTorch version of the grouped expert FFN kernel (the reference's
``moe_gmm_ref``): float32 throughout, cast to the input dtype at the end."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def act_and_up(g, h, activation: str):
    """``a * h`` of the gated FFN from the gate and up projections ``g`` and
    ``h``. ``gelu`` is the tanh approximation (JAX's default);
    ``sq_relu`` ignores the gate: ``relu(h)^2``."""
    if activation == "silu":
        return F.silu(g) * h
    if activation == "gelu":
        return F.gelu(g, approximate="tanh") * h
    if activation == "sq_relu":
        r = torch.clamp(h, min=0.0)
        return r * r
    raise ValueError(f"moe_gmm: unknown activation {activation!r}")


def moe_gmm_ref(x, w_gate, w_in, w_out, *, activation: str = "silu"):
    """x: [E, C, D]; w_gate/w_in: [E, D, F]; w_out: [E, F, D] → [E, C, D]:
    per expert ``(act(x @ w_gate) * (x @ w_in)) @ w_out``."""
    xf = x.float()
    g = torch.einsum("ecd,edf->ecf", xf, w_gate.float())
    h = torch.einsum("ecd,edf->ecf", xf, w_in.float())
    out = torch.einsum("ecf,efd->ecd", act_and_up(g, h, activation),
                       w_out.float())
    return out.to(x.dtype)
