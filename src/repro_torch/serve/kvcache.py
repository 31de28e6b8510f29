"""NAMKVCache (``repro/serve/kvcache.py``): the paged KV cache as a
network-attached-memory pool.

* **memory pool** → one shared page-id space: a :class:`PageMeta` (8-byte
  page headers from ``core/header.py`` and refcounts) governs allocation;
  each layer's :class:`PageData` stores K/V at those page ids.
* **record header** → one header per page: thread id = the allocating
  sequence, cts = the allocation epoch, deleted bit = free.
* **extend allocator / CAS** → allocation is a batched deterministic
  tournament (prefix-sum arbitration over the free list).
* **MVCC / snapshot reads** → prefix sharing: shared pages are refcounted;
  release sets the deleted bit only at refcount 0.
* **GC** → deleted pages re-enter the free list.

Headers are the port's int32 words holding uint32 bit patterns, the
epoch a 0-d int32 tensor of the same kind. The metadata functions return
new tensors, as the reference's do. The data path (:func:`write_token`,
:func:`write_prefill`) writes the pools in place: a pool made by
:func:`init_data` holds one page more than the page-id space, a sink page
that the table never names, where the writes the reference drops land.
Every other dropped write goes through a sink row of a scratch copy one
row longer (:func:`_drop_scatter`). The paged attention kernel walks the
page table itself; :func:`gather_kv` is what its plain version runs.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch._u32 import gidx, sidx, to_i32, u64
from repro_torch.core import header as hdr_ops

MAX_PAGES_PER_ALLOC = 64  # static bound on pages claimed per request


class PageMeta(NamedTuple):
    """Allocation state over the shared page-id space."""
    hdr: torch.Tensor        # int32 [P, 2] — page version headers
    refcount: torch.Tensor   # int32 [P]

    @property
    def n_pages(self) -> int:
        return self.hdr.shape[0]


class PageData(NamedTuple):
    """K/V payload of one layer."""
    k: torch.Tensor          # [P (+ 1 sink page), page, Hkv, Dh]
    v: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


class SeqTable(NamedTuple):
    page_table: torch.Tensor   # int32 [max_seqs, max_pages] (-1 = unmapped)
    kv_len: torch.Tensor       # int32 [max_seqs]
    active: torch.Tensor       # bool  [max_seqs]


def _drop_scatter(dst, index, values, accumulate=False):
    """``dst.at[index].set(values, mode="drop")`` (``.add`` with
    ``accumulate``) as a new tensor: ``index`` is a tuple of index tensors
    over the leading dimensions; a negative index wraps once, and an update
    with any index still out of range lands in a sink row of a scratch
    copy one row longer in each indexed dimension."""
    n = len(index)
    buf = F.pad(dst, (0, 0) * (dst.dim() - n) + (0, 1) * n)
    idx = tuple(sidx(i, dst.shape[d]) for d, i in enumerate(index))
    buf.index_put_(idx, values.to(buf.device, buf.dtype),
                   accumulate=accumulate)
    return buf[tuple(slice(0, s) for s in dst.shape[:n])].contiguous()


def init_meta(n_pages: int, device=None) -> PageMeta:
    dev = resolve_device(device)
    zeros = torch.zeros((n_pages,), dtype=torch.int32, device=dev)
    return PageMeta(hdr=hdr_ops.pack(zeros, zeros, deleted=True),
                    refcount=zeros.clone())


def init_data(n_pages: int, page_size: int, n_kv: int, d_head: int,
              dtype=torch.bfloat16, device=None) -> PageData:
    """Zeroed pools of ``n_pages`` pages and the sink page."""
    shape = (n_pages + 1, page_size, n_kv, d_head)
    dev = resolve_device(device)
    return PageData(k=torch.zeros(shape, dtype=dtype, device=dev),
                    v=torch.zeros(shape, dtype=dtype, device=dev))


def init_seq_table(max_seqs: int, max_pages: int, device=None) -> SeqTable:
    dev = resolve_device(device)
    return SeqTable(
        page_table=torch.full((max_seqs, max_pages), -1, dtype=torch.int32,
                              device=dev),
        kv_len=torch.zeros((max_seqs,), dtype=torch.int32, device=dev),
        active=torch.zeros((max_seqs,), dtype=torch.bool, device=dev))


# ------------------------------------------------------------ allocation ----
def alloc_pages(meta: PageMeta, want, tid, epoch
                ) -> Tuple[PageMeta, torch.Tensor, torch.Tensor]:
    """Transactionally claim pages for a batch of requesters.

    want: int32 [R] pages needed; tid: int32 [R] worker ids; epoch: the
    allocation epoch (uint32 bits). Free pages (deleted, refcount 0) are
    assigned by prefix-sum arbitration. Returns (meta', pages int32
    [R, MAX_PAGES_PER_ALLOC] (-1 padded), ok [R])."""
    R = want.shape[0]
    P = meta.n_pages
    dev = meta.hdr.device
    want = want.to(torch.int64)
    free = hdr_ops.is_deleted(meta.hdr) & (meta.refcount == 0)
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    n_free = free.sum()
    offsets = torch.cumsum(want, 0) - want
    ok = (offsets + want) <= n_free
    free_idx = _drop_scatter(
        torch.full((P,), -1, dtype=torch.int32, device=dev),
        (torch.where(free, free_rank, P),),
        torch.arange(P, dtype=torch.int32, device=dev))
    j = torch.arange(MAX_PAGES_PER_ALLOC, device=dev)
    take = (j[None, :] < want[:, None]) & ok[:, None]
    slot = torch.where(take, offsets[:, None] + j[None, :], P - 1)
    pages = torch.where(take, free_idx[gidx(slot, P)], -1)
    flat = pages.reshape(-1)
    claim = flat >= 0
    idx = torch.where(claim, flat, P)
    # flags as device tensors: a Python flag would be copied to the card,
    # and that copy waits for the device
    off = torch.zeros((), dtype=torch.bool, device=dev)
    new_hdr = hdr_ops.pack(
        tid.reshape(R, 1).expand(R, MAX_PAGES_PER_ALLOC).reshape(-1),
        torch.as_tensor(epoch, device=dev).expand(R * MAX_PAGES_PER_ALLOC),
        moved=off, deleted=off, locked=off)
    hdr = _drop_scatter(meta.hdr, (idx,), new_hdr)
    ref = _drop_scatter(meta.refcount, (idx,), claim.to(torch.int32),
                        accumulate=True)
    return PageMeta(hdr=hdr, refcount=ref), pages.to(torch.int32), ok


def map_pages(table: SeqTable, seq_ids, pages, start_page) -> SeqTable:
    """Install allocated pages into sequences' page tables."""
    R, W = pages.shape
    n_seqs, maxP = table.page_table.shape
    j = torch.arange(W, device=pages.device)
    valid = pages >= 0
    col = torch.where(valid, start_page.to(torch.int64)[:, None] + j, maxP)
    row = torch.where(valid, seq_ids.to(torch.int64)[:, None], n_seqs)
    pt = _drop_scatter(table.page_table, (row, col), pages)
    return table._replace(page_table=pt)


def release_seqs(meta: PageMeta, table: SeqTable, seq_ids
                 ) -> Tuple[PageMeta, SeqTable]:
    """Free sequences: decref their pages; refcount 0 ⇒ deleted (reusable).
    Shared prefix pages survive until their last reader releases."""
    n_seqs = table.page_table.shape[0]
    pt = table.page_table[gidx(seq_ids, n_seqs)]
    valid = pt >= 0
    idx = torch.where(valid, pt, meta.n_pages).reshape(-1)
    ref = _drop_scatter(meta.refcount, (idx,),
                        torch.where(valid, -1, 0).reshape(-1),
                        accumulate=True)
    freed = ref <= 0
    hdr = hdr_ops.with_deleted(meta.hdr,
                               freed | hdr_ops.is_deleted(meta.hdr))
    rows = (seq_ids,)
    zero = torch.zeros((), dtype=torch.int32, device=pt.device)
    table = table._replace(
        page_table=_drop_scatter(table.page_table, rows, zero - 1),
        active=_drop_scatter(table.active, rows, zero),
        kv_len=_drop_scatter(table.kv_len, rows, zero))
    return PageMeta(hdr=hdr, refcount=torch.clamp(ref, min=0)), table


def share_prefix(meta: PageMeta, table: SeqTable, src_seq, dst_seq,
                 n_pages_shared) -> Tuple[PageMeta, SeqTable]:
    """Prefix caching: dst reuses src's first n pages (an MVCC snapshot
    read — zero copy; refcounts pin the shared pages)."""
    n_seqs, maxP = table.page_table.shape
    dev = table.page_table.device
    j = torch.arange(maxP, device=dev)
    src_pages = table.page_table[gidx(torch.as_tensor(src_seq, device=dev),
                                      n_seqs)]
    dst = torch.as_tensor(dst_seq, device=dev).reshape(1)
    share = (j < n_pages_shared) & (src_pages >= 0)
    row = torch.where(share, src_pages,
                      table.page_table[gidx(dst, n_seqs)][0])
    pt = _drop_scatter(table.page_table, (dst,), row[None])
    idx = torch.where(share, src_pages, meta.n_pages)
    ref = _drop_scatter(meta.refcount, (idx,), share.to(torch.int32),
                        accumulate=True)
    return meta._replace(refcount=ref), table._replace(page_table=pt)


# ------------------------------------------------------------- data path ----
def _sink(data: PageData, page):
    """Page ids a write may use: a mapped page of the pool, else the sink
    page (the last of ``data``)."""
    P = data.k.shape[0] - 1
    return torch.where((page >= 0) & (page < P), page, P).long()


def write_token(data: PageData, table: SeqTable, seq_ids, k_new, v_new
                ) -> PageData:
    """Append one token's K/V per sequence at position kv_len, in place
    (an unmapped page drops the write into the sink page)."""
    ps = data.page_size
    n_seqs, maxP = table.page_table.shape
    s = gidx(seq_ids, n_seqs)
    pos = table.kv_len[s].long()
    page_of = table.page_table[s, gidx(torch.div(pos, ps,
                                                 rounding_mode="floor"),
                                       maxP)]
    idx = _sink(data, page_of)
    off = torch.remainder(pos, ps)
    data.k[idx, off] = k_new.to(data.k.dtype)
    data.v[idx, off] = v_new.to(data.v.dtype)
    return data


def write_prefill(data: PageData, table: SeqTable, seq_ids, k_seq, v_seq,
                  lens) -> PageData:
    """Bulk-write prompt K/V ([B, S, Hkv, Dh]) into mapped pages, in
    place."""
    B, S, Hkv, Dh = k_seq.shape
    ps = data.page_size
    n_seqs, maxP = table.page_table.shape
    pos = torch.arange(S, device=k_seq.device)[None, :]
    page_of = table.page_table[gidx(seq_ids, n_seqs)[:, None],
                               gidx(pos // ps, maxP)]
    page_of = torch.where(pos < lens[:, None], page_of, -1)
    idx = _sink(data, page_of).reshape(-1)
    off = (pos % ps).expand(B, S).reshape(-1)
    data.k[idx, off] = k_seq.reshape(-1, Hkv, Dh).to(data.k.dtype)
    data.v[idx, off] = v_seq.reshape(-1, Hkv, Dh).to(data.v.dtype)
    return data


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


def fragmentation(meta: PageMeta) -> torch.Tensor:
    """Telemetry: fraction of pages in use: the exact count times the
    float32 reciprocal of the page count, as the reference's float32 mean
    is formed (see ``core/gc.reclaimable_fraction``)."""
    used = ~hdr_ops.is_deleted(meta.hdr)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32,  # noqa: E731
                                 device=used.device)
    return used.sum().to(torch.float32) * (f32(1.0)
                                           / f32(float(used.numel())))


def next_epoch(epoch):
    """``epoch + 1`` of a uint32 epoch held as int32 bits."""
    return to_i32(u64(epoch) + 1)
