"""Plain PyTorch version of the selective scan kernel: the discretisation
of the reference's ``mamba_scan_ref`` (``a`` and ``b`` materialised in
float32) and the model stack's ``linear_rnn``."""
from __future__ import annotations

import torch

from repro_torch.models import recurrent


def mamba_scan_ref(dt, x, Bm, Cm, A_log, D_skip, *, h0=None,
                   return_state=False):
    """dt, x: [B, S, Di]; Bm, Cm: [B, S, N]; A_log: [Di, N]; D_skip: [Di];
    h0: the float32 state [B, Di, N] before the first step (zero when
    None, as the kernel's). Returns y: [B, S, Di] in x's dtype, and with
    ``return_state`` also ``(y, h_last)``, the float32 state [B, Di, N]
    after the last step (``linear_rnn``'s)."""
    B, S, Di = x.shape
    A = -torch.exp(A_log.float())
    a = torch.exp(dt.float()[..., None] * A[None, None])
    b = (dt * x).float()[..., None] * Bm.float()[:, :, None, :]
    if h0 is None:
        h0 = torch.zeros((B, Di, A.shape[1]), dtype=torch.float32,
                         device=x.device)
    hs, h_last = recurrent.linear_rnn(a, b, h0)
    del a, b
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm.float())
    y = (y + D_skip[None, None] * x).to(x.dtype)
    return (y, h_last) if return_state else y
