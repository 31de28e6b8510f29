"""Plain PyTorch version of the selective scan kernel: the discretisation
of the reference's ``mamba_scan_ref`` (``a`` and ``b`` materialised in
float32) and the model stack's ``linear_rnn``."""
from __future__ import annotations

import torch

from repro_torch.models.recurrent import linear_rnn


def mamba_scan_ref(dt, x, Bm, Cm, A_log, D_skip):
    """dt, x: [B, S, Di]; Bm, Cm: [B, S, N]; A_log: [Di, N]; D_skip: [Di].
    Returns y: [B, S, Di] in x's dtype."""
    B, S, Di = x.shape
    A = -torch.exp(A_log.float())
    a = torch.exp(dt.float()[..., None] * A[None, None])
    b = (dt * x).float()[..., None] * Bm.float()[:, :, None, :]
    h0 = torch.zeros((B, Di, A.shape[1]), dtype=torch.float32,
                     device=x.device)
    hs, _ = linear_rnn(a, b, h0)
    del a, b
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm.float())
    return (y + D_skip[None, None] * x).to(x.dtype)
