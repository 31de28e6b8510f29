"""The chunked linear recurrence of the recurrent blocks
(``repro/models/recurrent.py``); the Mamba scan's plain version runs it."""
from __future__ import annotations

import torch


def linear_rnn(a, b, h0):
    """h_t = a_t ⊙ h_{t-1} + b_t. a, b: [B, S, ...]; h0: [B, ...]. Returns
    (outputs [B, S, ...], h_last).

    The reference unrolls a chunk of steps inside each step of a scan and
    pads the last chunk with a = 1, b = 0, which leaves the state as it
    is; here the steps simply run in order, which computes the same.
    """
    outs = torch.empty(a.shape, dtype=torch.result_type(a, b),
                       device=a.device)
    h = h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        outs[:, t] = h
    return outs, h
