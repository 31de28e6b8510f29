"""Plain PyTorch version of the flash attention kernel: the model stack's
``chunked_attention``, as the reference's ``ref.py`` delegates to it."""
from __future__ import annotations

import torch

from repro_torch.models import common


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None):
    """q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] → [B, Sq, Hq, D]."""
    B, Sq = q.shape[0], q.shape[1]
    Sk = k.shape[1]
    pos_q = torch.arange(Sq, device=q.device)[None].expand(B, Sq)
    pos_k = torch.arange(Sk, device=q.device)[None].expand(B, Sk)
    return common.chunked_attention(
        q, k, v, positions_q=pos_q, positions_k=pos_k, causal=causal,
        window=window, attn_cap=softcap, scale=scale, chunk=min(512, Sk))
