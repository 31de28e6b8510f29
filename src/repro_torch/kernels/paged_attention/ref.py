"""Plain PyTorch version of the paged decode attention kernel: the
materialising ``gather_kv`` followed by the model stack's
``decode_attention``, as the reference's ``ref.py`` composes them."""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.serve import kvcache as kvc


def paged_attention_ref(q, k_pool, v_pool, page_table, kv_len, *,
                        window=None, softcap=None, scale=None):
    """q: [B, Hq, D]; k/v_pool: [P, ps, Hkv, D]; page_table: [B, n_pages]
    int32 (-1 = unmapped); kv_len: [B] int32. Returns [B, Hq, D]."""
    B = q.shape[0]
    n_pages = page_table.shape[1]
    ps = k_pool.shape[1]
    data = kvc.PageData(k=k_pool, v=v_pool)
    table = kvc.SeqTable(page_table=page_table, kv_len=kv_len,
                         active=torch.ones((B,), dtype=torch.bool,
                                           device=q.device))
    kc, vc = kvc.gather_kv(data, table, torch.arange(B, device=q.device),
                           n_pages * ps)
    return common.decode_attention(q, kc, vc, kv_len, window=window,
                                   attn_cap=softcap, scale=scale)
