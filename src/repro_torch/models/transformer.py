"""The LM assembled from pattern units (``repro/models/transformer.py``).

The reference stacks each pattern-unit position's parameters over
``n_units`` and scans; the port holds a ``ModuleList`` of ``n_layers``
layers in execution order, layer ``u·unit_len + p`` being the reference's
``u{p}[u]``, and runs them in that order. A cache holds one
:class:`~repro_torch.models.blocks.LayerCacheSlot` a layer, in the same
order.

Entry points, for decoder-only configurations (attention, hybrid and
recurrent):
  init_params     → a :class:`Transformer` with random weights
  forward_hidden  → final hidden states (and each layer's cache slot)
  prefill         → (last hidden, DecodeCache)
  decode_step     → one-token serve step against a DecodeCache

``kernels=False`` keeps a CUDA call of ``forward_hidden``, ``prefill`` or
``decode_step`` on the plain path. ``encode`` and the encoder-decoder and
prefix-LM branches wait for slice F2b; ``train_loss`` and
``chunked_cross_entropy`` wait for slice F3 (training).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, common

_VOCAB_CHUNK = 32_768   # rows of the embedding widened to float32 at once


class Transformer(nn.Module):
    """``embed`` [V, D], ``final_ln`` [D] and ``layers``, a ``ModuleList``
    of ``n_layers`` :class:`~repro_torch.models.blocks.Layer` s in
    execution order, on ``device`` (the card unless the CPU is asked
    for). Weights are drawn from ``generator`` when one is given, else
    left uninitialised."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None,
                 generator=None):
        super().__init__()
        if cfg.is_encdec or cfg.is_prefix_lm:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder and prefix-LM models wait "
                f"for slice F2b")
        dtype = dtype or cfg.param_dtype
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab, cfg.d_model), dtype=dtype, device=device))
        self.final_ln = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        unit = cfg.unit()
        self.layers = nn.ModuleList(
            blocks.Layer(cfg, unit[i % len(unit)], dtype, device, generator)
            for i in range(cfg.n_layers))
        if generator is not None:
            common.normal_(self.embed, cfg.d_model ** -0.5, generator)


class DecodeCache(NamedTuple):
    """One LayerCacheSlot a layer, in execution order (K/V ``[B, S, Hkv,
    Dh]`` for attention, the recurrent state for the other kinds), and
    ``kv_len`` [B], the tokens already in the cache."""
    slots: tuple
    kv_len: torch.Tensor
    enc_kv: tuple = ()


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None,
                dtype=None) -> Transformer:
    """A Transformer whose weights are drawn from ``generator`` directly on
    ``device`` (the card unless the CPU is asked for)."""
    return Transformer(cfg, dtype=dtype, device=device, generator=generator)


def forward_hidden(cfg: ArchConfig, params, tokens_or_embeds, *,
                   prefix_len=None, causal=True, collect_cache=False,
                   kernels=True):
    """Full-sequence forward to final hidden states.

    tokens_or_embeds: int tokens [B, S] or embeddings [B, S, D]. Returns
    (hidden [B, S, D], one LayerCacheSlot a layer or None). ``kernels``
    lets CUDA calls run the LM kernels (``False`` keeps the card on the
    plain path; on the CPU it has no effect)."""
    if tokens_or_embeds.dim() == 2:
        x = common.embed_lookup(params.embed, tokens_or_embeds)
    else:
        x = tokens_or_embeds
    slots = []
    for layer in params.layers:
        # positions None: 0..S-1 in every row
        x, slot = blocks.layer_forward(layer, x, None, cfg, layer.spec,
                                       prefix_len=prefix_len, causal=causal,
                                       kernels=kernels)
        slots.append(slot)
    x = common.rms_norm(x, params.final_ln, cfg.norm_eps)
    return x, (tuple(slots) if collect_cache else None)


def lm_head(h, embed, cap: Optional[float]):
    """Float32 logits [..., V] of hidden states ``h`` [..., D] against the
    tied embedding, softcapped: the reference's float32 product, with the
    embedding widened ``_VOCAB_CHUNK`` rows at a time."""
    hf = h.float()
    logits = torch.cat([hf @ embed[i:i + _VOCAB_CHUNK].float().T
                        for i in range(0, embed.shape[0], _VOCAB_CHUNK)],
                       dim=-1)
    return common.softcap(logits, cap)


@torch.no_grad()
def prefill(cfg: ArchConfig, params, batch, max_len: int, kernels=True):
    """Run the prompt ``batch["tokens"]`` [B, S], build a DecodeCache whose
    attention K/V are padded to ``max_len`` (at least S + 1); recurrent
    slots carry their state as it is. Returns (last hidden [B, D],
    cache)."""
    tokens = batch["tokens"]
    hidden, slots = forward_hidden(cfg, params, tokens, collect_cache=True,
                                   kernels=kernels)
    B, S = tokens.shape
    max_len = max(max_len, S + 1)
    pad = (0, 0, 0, 0, 0, max_len - S)
    slots = tuple(s._replace(k=F.pad(s.k, pad), v=F.pad(s.v, pad))
                  if layer.spec.kind == "attn" else s
                  for s, layer in zip(slots, params.layers))
    kv_len = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return hidden[:, -1], DecodeCache(slots=slots, kv_len=kv_len)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache: DecodeCache, token,
                kernels=True):
    """token [B] int32 → (logits [B, V] float32, new cache). One serve
    step; the cache's K/V are written in place, the recurrent states
    replaced."""
    x = common.embed_lookup(params.embed, token)[:, None, :]   # [B, 1, D]
    new_slots = []
    for layer, slot in zip(params.layers, cache.slots):
        x, slot = blocks.layer_decode(layer, x, slot, cache.kv_len, cfg,
                                      layer.spec, kernels=kernels)
        new_slots.append(slot)
    x = common.rms_norm(x, params.final_ln, cfg.norm_eps)
    logits = lm_head(x[:, 0], params.embed, cfg.logit_softcap)
    return logits, cache._replace(slots=tuple(new_slots),
                                  kv_len=cache.kv_len + 1)
