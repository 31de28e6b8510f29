"""The paged KV cache's data and sequence table, and the gather of a
sequence's pages (``repro/serve/kvcache.py``: ``PageData``, ``SeqTable``,
``gather_kv`` only). The paged attention kernel walks the page table
itself; ``gather_kv`` is what its plain version runs."""
from __future__ import annotations

from typing import NamedTuple

import torch


class PageData(NamedTuple):
    """K/V payload of one layer position."""
    k: torch.Tensor          # [P, page, Hkv, Dh]
    v: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


class SeqTable(NamedTuple):
    page_table: torch.Tensor   # int32 [max_seqs, max_pages] (-1 = unmapped)
    kv_len: torch.Tensor       # int32 [max_seqs]
    active: torch.Tensor       # bool  [max_seqs]


def gather_kv(data: PageData, table: SeqTable, seq_ids, max_len: int):
    """Materialize [B, max_len, Hkv, Dh] views of the sequences ``seq_ids``:
    an unmapped page reads as zeros, and a page id past the pool reads the
    last page (JAX gathers clamp)."""
    ps = data.page_size
    n_pages = max_len // ps
    pt = table.page_table[seq_ids, :n_pages]
    ok = pt >= 0
    idx = torch.where(ok, pt, 0).long().clamp(max=data.k.shape[0] - 1)
    zero = torch.zeros((), dtype=data.k.dtype, device=data.k.device)
    k = torch.where(ok[:, :, None, None, None], data.k[idx], zero)
    v = torch.where(ok[:, :, None, None, None], data.v[idx], zero)
    B = pt.shape[0]
    return (k.reshape(B, n_pages * ps, *k.shape[3:]),
            v.reshape(B, n_pages * ps, *v.shape[3:]))
