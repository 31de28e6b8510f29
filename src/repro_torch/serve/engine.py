"""Continuous-batching serving engine over the NAM page pool
(``repro/serve/engine.py``).

The engine is a "compute server": stateless decode logic over
externalised state (page meta, one page pool a layer, the sequence
table). Page ids form ONE shared space: :class:`~repro_torch.serve.kvcache.
PageMeta` governs allocation and every layer stores its K/V at the same
ids. Single-host loop, greedy sampling, attention-pattern architectures
only, as the reference's: the recurrent and hybrid ones serve through
``models/api`` (``Model.prefill`` / ``decode_step``).

On the card (``kernels=True``) prefill attention is the ``flash_attention``
kernel, the experts the ``moe_gmm`` kernel, and decode attention the
``paged_attention`` kernel over the engine's own pools and page table. The
paged kernel follows the reference's TPU kernel, which skips an unmapped
page below ``kv_len`` where the plain ``gather_kv`` + ``decode_attention``
weighs its zeros. So each step the host picks, from the table it reads
anyway (:meth:`Engine.ensure_capacity`), the lanes whose visible pages are
all mapped (:func:`kernel_lanes`) for the kernel, and serves the others
(slots never admitted or released, a finished lane at a page boundary, a
prompt longer than ``MAX_PAGES_PER_ALLOC`` pages) with the plain path on
their own sub-batch. ``kernels=False``, and any CPU engine, runs the
reference's plain path throughout.

Decode runs the layers in the reference's order, which is not the
execution order when a pattern unit has more than one layer: for each unit
position, that position's layer of every unit (gemma2: every local
layer, then every global layer). ``transformer.decode_step`` runs them
unit by unit.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import header as hdr_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import blocks, common
from repro_torch.models.transformer import forward_hidden, lm_head
from repro_torch.serve import kvcache as kvc


@dataclasses.dataclass
class EngineConfig:
    max_seqs: int = 8
    page_size: int = 16
    n_pages: int = 256
    max_len: int = 256
    eos: int = 1


class EngineState(NamedTuple):
    meta: kvc.PageMeta
    data: tuple             # one PageData a layer, in execution order
    table: kvc.SeqTable
    tokens: torch.Tensor    # int32 [max_seqs] — last emitted token
    done: torch.Tensor      # bool  [max_seqs]
    epoch: torch.Tensor     # 0-d int32: the uint32 allocation epoch


def kernel_lanes(kv_len, mapped, page_size: int, window=None):
    """Host-side bool [B]: the lanes whose decode attention (over
    ``kv_len + 1`` tokens, the last ``window`` of them when given) sees
    only mapped pages, the paged kernel's contract. ``kv_len`` [B] and
    ``mapped`` [B, n_pages] (page table >= 0) are numpy arrays."""
    kvl = kv_len.astype(np.int64) + 1
    lo = np.zeros_like(kvl) if window is None \
        else np.maximum(kvl - window, 0)
    col = np.arange(mapped.shape[1])[None, :]
    visible = (col >= (lo // page_size)[:, None]) \
        & (col < (-(-kvl // page_size))[:, None])
    return (mapped | ~visible).all(axis=1)


class Engine:
    """``params`` is a :class:`~repro_torch.models.transformer.Transformer`
    on ``device`` (the card unless the CPU is asked for). ``kernels``
    lets the engine's CUDA calls run the LM kernels; ``False`` keeps the
    card on the plain path."""

    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig, *,
                 kernels: bool = True, device=None):
        unit = cfg.unit()
        if not all(s.kind == "attn" for s in unit):
            raise ValueError("paged engine serves attention archs; SSM "
                             "archs use models/api")
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"parameters on {params.embed.device}, engine "
                             f"on {self.device}")
        self.cfg, self.ecfg, self.params = cfg, ecfg, params
        self.kernels = kernels
        self.paged = kernels and self.device.type == "cuda"
        ul = len(unit)
        self.decode_order = [u * ul + p for p in range(ul)
                             for u in range(cfg.n_units)]
        self.windows = sorted({s.window for s in unit},
                              key=lambda w: (w is not None, w))
        # per window of the last decode step: (kernel lanes, plain lanes)
        self.last_split = {}

    def init_state(self) -> EngineState:
        cfg, e, dev = self.cfg, self.ecfg, self.device
        data = tuple(kvc.init_data(e.n_pages, e.page_size, cfg.n_kv_heads,
                                   cfg.d_head, device=dev)
                     for _ in range(cfg.n_layers))
        return EngineState(
            meta=kvc.init_meta(e.n_pages, dev), data=data,
            table=kvc.init_seq_table(e.max_seqs, e.max_len // e.page_size,
                                     dev),
            tokens=torch.zeros((e.max_seqs,), dtype=torch.int32, device=dev),
            done=torch.ones((e.max_seqs,), dtype=torch.bool, device=dev),
            epoch=torch.zeros((), dtype=torch.int32, device=dev))

    def _put(self, a, dtype=None):
        """A host array on the engine's device. On the card it goes through
        pinned memory without waiting: a plain copy from pageable memory
        would synchronise the host with the device."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _host(self, state: EngineState):
        """One copy to the host: kv_len, active, done, the page table and
        the free page count."""
        t, m = state.table, state.meta
        free = (hdr_ops.is_deleted(m.hdr) & (m.refcount == 0)).sum()
        flat = torch.cat([t.kv_len, t.active.int(), state.done.int(),
                          t.page_table.reshape(-1),
                          free.to(torch.int32).reshape(1)]).cpu().numpy()
        S = t.kv_len.shape[0]
        return (flat[:S], flat[S:2 * S].astype(bool),
                flat[2 * S:3 * S].astype(bool),
                flat[3 * S:-1].reshape(S, -1), int(flat[-1]))

    # ------------------------------------------------------------ admit ----
    @torch.no_grad()
    def admit_logits(self, state: EngineState, prompts: List[np.ndarray]):
        """Admit requests into free slots: tournament page allocation, model
        prefill, bulk page writes. Returns (state, the admitted slots' first
        logits [B', V] float32, their slot ids); the pools are written in
        place."""
        e, cfg, dev = self.ecfg, self.cfg, self.device
        _, active, _, _, n_free = self._host(state)
        free_slots = np.flatnonzero(~active)
        prompts = prompts[: len(free_slots)]
        if not prompts:
            return state, None, None
        B = len(prompts)
        S = max(len(p) for p in prompts)
        S = -(-S // e.page_size) * e.page_size
        toks = np.zeros((B, S), np.int32)
        lens = np.array([len(p) for p in prompts], np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        want = -(-lens // e.page_size)
        if want.sum() > n_free:
            raise RuntimeError("page pool exhausted")
        seq_ids = self._put(free_slots[:B], np.int32)
        lens_t = self._put(lens)
        epoch = kvc.next_epoch(state.epoch)
        meta, pages, _ = kvc.alloc_pages(state.meta, self._put(want),
                                         seq_ids, epoch)
        table = kvc.map_pages(state.table, seq_ids, pages,
                              torch.zeros_like(seq_ids))
        kv_len, act = table.kv_len.clone(), table.active.clone()
        kv_len[seq_ids.long()] = lens_t
        act[seq_ids.long()] = True
        table = table._replace(kv_len=kv_len, active=act)

        hidden, slots = forward_hidden(cfg, self.params, self._put(toks),
                                       collect_cache=True,
                                       kernels=self.kernels)
        for d, slot in zip(state.data, slots):
            kvc.write_prefill(d, table, seq_ids, slot.k, slot.v, lens_t)
        last_h = hidden[torch.arange(B, device=dev), lens_t.long() - 1]
        logits = lm_head(last_h, self.params.embed, cfg.logit_softcap)
        return state._replace(meta=meta, table=table, epoch=epoch), \
            logits, seq_ids

    def sample_first(self, state: EngineState, logits, seq_ids
                     ) -> EngineState:
        """Each admitted slot's first token (greedy); it is not done."""
        if logits is None:
            return state
        tokens, done = state.tokens.clone(), state.done.clone()
        tokens[seq_ids.long()] = logits.argmax(dim=-1).to(torch.int32)
        done[seq_ids.long()] = False
        return state._replace(tokens=tokens, done=done)

    def admit(self, state: EngineState, prompts: List[np.ndarray]
              ) -> EngineState:
        """:meth:`admit_logits`, then :meth:`sample_first`."""
        return self.sample_first(*self.admit_logits(state, prompts))

    # ----------------------------------------------------------- decode ----
    def _ensure(self, state: EngineState):
        """:meth:`ensure_capacity`, and what it read on the host: kv_len
        and the page table's mapped entries after the new pages."""
        e = self.ecfg
        kv_len, active, done, pt, n_free = self._host(state)
        # a sequence at max_len is out of cache room: force-finish it
        at_cap = (kv_len >= e.max_len) & active
        if at_cap.any():
            state = state._replace(done=state.done | self._put(at_cap))
            done = done | at_cap
        mapped = pt >= 0
        need = [s for s in np.flatnonzero(active & ~done)
                if not mapped[s, kv_len[s] // e.page_size]]
        if not need:
            return state, kv_len, mapped
        if len(need) > n_free:
            raise RuntimeError("page pool exhausted mid-decode")
        seq_ids = self._put(need, np.int32)
        epoch = kvc.next_epoch(state.epoch)
        meta, pages, _ = kvc.alloc_pages(
            state.meta, torch.ones_like(seq_ids), seq_ids, epoch)
        start = kv_len[need] // e.page_size
        table = kvc.map_pages(state.table, seq_ids, pages,
                              self._put(start, np.int32))
        mapped[need, start] = True
        return state._replace(meta=meta, table=table, epoch=epoch), \
            kv_len, mapped

    def ensure_capacity(self, state: EngineState) -> EngineState:
        """Allocate a fresh page for any active sequence whose next token
        would cross into an unmapped page (transactional, batched)."""
        return self._ensure(state)[0]

    def _split(self, kv_len, mapped):
        """Per window: the index tensors of the kernel's lanes and of the
        plain sub-batch's; None for a side without lanes, and for the
        kernel's side when it has every lane."""
        B = kv_len.shape[0]
        self.last_split, lanes = {}, {}
        for w in self.windows:
            ok = kernel_lanes(kv_len, mapped, self.ecfg.page_size, w) \
                if self.paged else np.zeros(B, bool)
            good, bad = np.flatnonzero(ok), np.flatnonzero(~ok)
            self.last_split[w] = (good, bad)
            lanes[w] = (self._put(good) if len(good) and len(bad) else None,
                        self._put(bad) if len(bad) else None)
        return lanes

    def _attend(self, q, d, table, kv_len1, window, lanes):
        """Decode attention of every lane: the paged kernel on its lanes,
        ``gather_kv`` + ``decode_attention`` on the rest."""
        cap = self.cfg.attn_softcap
        good, bad = lanes
        if bad is None:
            return paged_ops.paged_attention(q, d.k, d.v, table.page_table,
                                             kv_len1, window=window,
                                             softcap=cap)
        kc, vc = kvc.gather_kv(d, table, bad, self.ecfg.max_len)
        o_bad = common.decode_attention(q[bad], kc, vc, kv_len1[bad],
                                        window=window, attn_cap=cap)
        if good is None:
            return o_bad
        o = torch.empty_like(q)
        o[bad] = o_bad
        o[good] = paged_ops.paged_attention(
            q[good], d.k, d.v, table.page_table[good], kv_len1[good],
            window=window, softcap=cap)
        return o

    @torch.no_grad()
    def decode_logits(self, state: EngineState):
        """:meth:`ensure_capacity`, then one token of every slot through the
        model. Returns (state, logits [max_seqs, V] float32); the pools are
        written in place, nothing is sampled."""
        cfg, e = self.cfg, self.ecfg
        state, kv_len, mapped = self._ensure(state)
        lanes = self._split(kv_len, mapped)
        table = state.table
        B = e.max_seqs
        seq_ids = torch.arange(B, dtype=torch.int32, device=self.device)
        x = common.embed_lookup(self.params.embed, state.tokens)[:, None, :]
        pos = table.kv_len
        kv_len1 = pos + 1       # the new token's K/V is written first
        Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        for i in self.decode_order:
            p, d = self.params.layers[i], state.data[i]
            a = p.attn
            h = common.rms_norm(x, p.ln1, cfg.norm_eps)
            q = (h @ a.wq).reshape(B, Hq, Dh)
            k = (h @ a.wk).reshape(B, 1, Hkv, Dh)
            v = (h @ a.wv).reshape(B, Hkv, Dh)
            k = common.rope(k, pos[:, None], cfg.rope_theta)[:, 0]
            q = common.rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
            kvc.write_token(d, table, seq_ids, k, v)
            o = self._attend(q, d, table, kv_len1, p.spec.window,
                             lanes[p.spec.window])
            x = x + o.reshape(B, 1, Hq * Dh) @ a.wo
            if p.spec.mlp == "dense":
                h2 = common.rms_norm(x, p.ln2, cfg.norm_eps)
                x = x + blocks.mlp_forward(p.mlp, h2, cfg)
            elif p.spec.mlp == "moe":
                x = x + blocks.moe_block(p, x, cfg,
                                         max(2.0, cfg.capacity_factor),
                                         self.kernels)
        x = common.rms_norm(x, self.params.final_ln, cfg.norm_eps)
        return state, lm_head(x[:, 0], self.params.embed, cfg.logit_softcap)

    def sample(self, state: EngineState, logits) -> EngineState:
        """Greedy next token of every active lane; an EOS finishes it."""
        table = state.table
        active = table.active & ~state.done
        nxt = logits.argmax(dim=-1).to(torch.int32)
        nxt = torch.where(active, nxt, state.tokens)
        done = state.done | (active & (nxt == self.ecfg.eos))
        table = table._replace(
            kv_len=torch.where(active, table.kv_len + 1, table.kv_len))
        return state._replace(table=table, tokens=nxt, done=done)

    def decode_step(self, state: EngineState) -> EngineState:
        """One token for every active sequence (the batched serve step)."""
        return self.sample(*self.decode_logits(state))

    # ---------------------------------------------------------- release ----
    def release_finished(self, state: EngineState) -> EngineState:
        finished = np.flatnonzero(
            (state.table.active & state.done).cpu().numpy())
        if len(finished) == 0:
            return state
        meta, table = kvc.release_seqs(state.meta, state.table,
                                       self._put(finished, np.int32))
        return state._replace(meta=meta, table=table)

    def serve(self, prompts: List[np.ndarray], max_new: int = 16):
        """Convenience driver: admit → decode until done → harvest."""
        n = len(prompts)
        state = self.admit(self.init_state(), prompts)
        outs = [[int(t)] for t in state.tokens[:n].cpu()]
        for _ in range(max_new - 1):
            if bool(state.done[:n].all()):
                break
            state = self.decode_step(state)
            tokens, done = state.tokens[:n].cpu(), state.done[:n].cpu()
            for i in range(n):
                if not done[i]:
                    outs[i].append(int(tokens[i]))
        return outs, self.release_finished(state)
