"""The LM assembled from pattern units (``repro/models/transformer.py``).

The reference stacks each pattern-unit position's parameters over
``n_units`` and scans; the port holds a ``ModuleList`` of ``n_layers``
layers in execution order, layer ``u·unit_len + p`` being the reference's
``u{p}[u]``, and runs them in that order. A cache holds one
:class:`~repro_torch.models.blocks.LayerCacheSlot` a layer, in the same
order. An encoder-decoder configuration (whisper) also holds the
``encoder`` and one cross-attention a layer (``cross[i]``, the
reference's ``cross`` at the same flat index); a prefix-LM (paligemma)
takes ``cfg.prefix_len`` patch embeddings before the tokens.

Entry points, for every configuration (attention, hybrid, recurrent,
encoder-decoder and prefix-LM):
  init_params     → a :class:`Transformer` with random weights
  encode          → the encoder's output for stub frame embeddings
  forward_hidden  → final hidden states (and each layer's cache slot)
  train_loss      → scalar loss (chunked cross-entropy; never
                    materializes [B, S, V])
  prefill         → (last hidden, DecodeCache), the encoder pass and the
                    prefix included
  decode_step     → one-token serve step against a DecodeCache

``kernels=False`` keeps a CUDA call of ``encode``, ``forward_hidden``,
``prefill`` or ``decode_step`` on the plain path. ``train_loss`` always
runs the plain path: no kernel has a gradient (module docstring of
``train_loss``).

Under autograd the policy's ``remat_unit`` checkpoints each unit of
``unit_len`` layers (the reference's scanned unit body), and with
``remat_save_block_out`` each block's body instead
(``blocks.layer_forward(remat_blocks=True)``), which keeps the block
outputs; neither changes a value.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch import policy
from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, common

_VOCAB_CHUNK = 32_768   # rows of the embedding widened to float32 at once


def _norm_scale(cfg: ArchConfig, device):
    return nn.Parameter(torch.zeros(cfg.d_model, device=device))


class EncoderLayer(nn.Module):
    """One encoder layer: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, dtype, device=None, generator=None):
        super().__init__()
        self.ln1 = _norm_scale(cfg, device)
        self.attn = blocks.init_attn(cfg, dtype, generator=generator,
                                     device=device)
        self.ln2 = _norm_scale(cfg, device)
        self.mlp = blocks.init_mlp(cfg, dtype, generator=generator,
                                   device=device)


class Encoder(nn.Module):
    """``layers``, ``encoder_layers`` :class:`EncoderLayer` s, and
    ``final_ln`` (the reference's ``_init_encoder``)."""

    def __init__(self, cfg: ArchConfig, dtype, device=None, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, dtype, device, generator)
            for _ in range(cfg.encoder_layers))
        self.final_ln = _norm_scale(cfg, device)


class CrossAttention(nn.Module):
    """A decoder layer's cross-attention: ``ln`` and ``attn``."""

    def __init__(self, cfg: ArchConfig, dtype, device=None, generator=None):
        super().__init__()
        self.ln = _norm_scale(cfg, device)
        self.attn = blocks.init_cross_attn(cfg, dtype, generator=generator,
                                           device=device)


class Transformer(nn.Module):
    """``embed`` [V, D], ``final_ln`` [D] and ``layers``, a ``ModuleList``
    of ``n_layers`` :class:`~repro_torch.models.blocks.Layer` s in
    execution order; for an encoder-decoder configuration also
    ``encoder`` (:class:`Encoder`) and ``cross``, a ``ModuleList`` of one
    :class:`CrossAttention` a layer. On ``device`` (the card unless the
    CPU is asked for). Weights are drawn from ``generator`` when one is
    given, else left uninitialised."""

    def __init__(self, cfg: ArchConfig, *, dtype=None, device=None,
                 generator=None):
        super().__init__()
        dtype = dtype or cfg.param_dtype
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab, cfg.d_model), dtype=dtype, device=device))
        self.final_ln = _norm_scale(cfg, device)
        unit = cfg.unit()
        self.layers = nn.ModuleList(
            blocks.Layer(cfg, unit[i % len(unit)], dtype, device, generator)
            for i in range(cfg.n_layers))
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, dtype, device, generator)
            self.cross = nn.ModuleList(
                CrossAttention(cfg, dtype, device, generator)
                for _ in range(cfg.n_layers))
        if generator is not None:
            common.normal_(self.embed, cfg.d_model ** -0.5, generator)


class DecodeCache(NamedTuple):
    """One LayerCacheSlot a layer, in execution order (K/V ``[B, S, Hkv,
    Dh]`` for attention, the recurrent state for the other kinds),
    ``kv_len`` [B], the tokens already in the cache, and ``enc_kv``,
    ``(enc_out,)`` for an encoder-decoder (``()`` otherwise)."""
    slots: tuple
    kv_len: torch.Tensor
    enc_kv: tuple = ()


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None,
                dtype=None) -> Transformer:
    """A Transformer whose weights are drawn from ``generator`` directly on
    ``device`` (the card unless the CPU is asked for)."""
    return Transformer(cfg, dtype=dtype, device=device, generator=generator)


def encode(cfg: ArchConfig, params, frames, kernels=True):
    """Encoder pass (whisper): frames [B, Se, D], precomputed stub
    embeddings (the conv frontend is out of scope), through non-causal
    self-attention at the positions ``0..Se-1``."""
    x = frames
    for p in params.encoder.layers:
        h = common.rms_norm(x, p.ln1, cfg.norm_eps)
        y, _ = blocks.attn_forward(p.attn, h, None, cfg, window=None,
                                   causal=False, kernels=kernels)
        x = x + y
        h = common.rms_norm(x, p.ln2, cfg.norm_eps)
        x = x + blocks.mlp_forward(p.mlp, h, cfg)
    return common.rms_norm(x, params.encoder.final_ln, cfg.norm_eps)


def cross_attend(cfg: ArchConfig, p, x, enc_out, positions, kernels=True):
    """Layer ``x`` [B, S, D] plus its cross-attention ``p`` over the
    encoder's output [B, Se, D], projected through ``wk`` and ``wv`` in
    this call, at the key positions ``0..Se-1``; the queries are roped
    at ``positions`` (None: ``0..S-1``)."""
    h = common.rms_norm(x, p.ln, cfg.norm_eps)
    B, Se, _ = enc_out.shape
    k = (enc_out @ p.attn.wk).reshape(B, Se, cfg.n_kv_heads, cfg.d_head)
    v = (enc_out @ p.attn.wv).reshape(B, Se, cfg.n_kv_heads, cfg.d_head)
    y, _ = blocks.attn_forward(p.attn, h, positions, cfg, window=None,
                               causal=False, kv_override=(k, v, None),
                               kernels=kernels)
    return x + y


def forward_hidden(cfg: ArchConfig, params, tokens_or_embeds, *,
                   prefix_len=None, enc_out=None, causal=True,
                   collect_cache=False, kernels=True):
    """Full-sequence forward to final hidden states.

    tokens_or_embeds: int tokens [B, S] or embeddings [B, S, D].
    ``prefix_len``: [B], or an int for every row (prefix-LM); ``enc_out``
    [B, Se, D]: the encoder's output, which every layer's cross-attention
    reads (encoder-decoder). Returns (hidden [B, S, D], one
    LayerCacheSlot a layer or None). ``kernels`` lets CUDA calls run the
    LM kernels (``False`` keeps the card on the plain path; on the CPU
    it has no effect)."""
    if tokens_or_embeds.dim() == 2:
        x = common.embed_lookup(params.embed, tokens_or_embeds)
    else:
        x = tokens_or_embeds
    pol = policy.current()
    remat = pol.remat_unit and torch.is_grad_enabled()
    by_block = remat and pol.remat_save_block_out
    ul = cfg.unit_len

    def unit(x, u):
        slots = []
        for i in range(u * ul, (u + 1) * ul):
            layer = params.layers[i]
            # positions None: 0..S-1 in every row
            x, slot = blocks.layer_forward(
                layer, x, None, cfg, layer.spec, prefix_len=prefix_len,
                causal=causal, kernels=kernels, remat_blocks=by_block)
            if cfg.is_encdec:
                args = (cfg, params.cross[i], x, enc_out, None, kernels)
                x = blocks.checkpointed(cross_attend, *args) if by_block \
                    else cross_attend(*args)
            slots.append(slot)
        return x, slots

    slots = []
    for u in range(len(params.layers) // ul):
        if remat and not by_block:
            x, s = torch.utils.checkpoint.checkpoint(unit, x, u,
                                                     use_reentrant=False)
        else:
            x, s = unit(x, u)
        slots += s
    x = common.rms_norm(x, params.final_ln, cfg.norm_eps)
    return x, (tuple(slots) if collect_cache else None)


def train_loss(cfg: ArchConfig, params, batch):
    """The mean next-token loss of ``batch``: ``tokens``, ``targets`` and
    ``mask`` [B, S], and ``frames`` [B, encoder_seq, D] (encoder-decoder)
    or ``patches`` [B, prefix_len, D] (prefix-LM), the stub frontends'
    embeddings; the loss covers the token positions only.

    It runs the plain path (``kernels=False``) on every device: the
    reference trains by autodiff of its plain functions and gives no
    kernel a gradient, and the port's kernel wrappers write outputs that
    autograd cannot see through, so they refuse a call that needs a
    gradient."""
    enc_out, prefix_len, inputs = None, None, batch["tokens"]
    if cfg.is_encdec:
        enc_out = encode(cfg, params, batch["frames"], kernels=False)
    if cfg.is_prefix_lm:
        x_tok = common.embed_lookup(params.embed, batch["tokens"])
        inputs = torch.cat([batch["patches"].to(x_tok.dtype), x_tok], 1)
        prefix_len = cfg.prefix_len
    hidden, _ = forward_hidden(cfg, params, inputs, prefix_len=prefix_len,
                               enc_out=enc_out, kernels=False)
    if cfg.is_prefix_lm:
        hidden = hidden[:, cfg.prefix_len:]
    loss, _ = common.chunked_cross_entropy(
        hidden, params.embed, batch["targets"], batch["mask"],
        logit_cap=cfg.logit_softcap)
    return loss


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
    """Run the prompt ``batch["tokens"]`` [B, S] (after the encoder pass
    over ``batch["frames"]`` [B, Se, D] for an encoder-decoder, and behind
    the prefix ``batch["patches"]`` [B, prefix_len, D] for a prefix-LM),
    build a DecodeCache whose attention K/V are padded to ``max_len`` (at
    least the sequence plus 1); recurrent slots carry their state as it
    is, and ``enc_kv`` holds the encoder's output. Returns (last hidden
    [B, D], cache)."""
    tokens = batch["tokens"]
    enc_out, prefix_len, inputs = None, None, tokens
    if cfg.is_encdec:
        enc_out = encode(cfg, params, batch["frames"], kernels)
    if cfg.is_prefix_lm:
        x_tok = common.embed_lookup(params.embed, tokens)
        inputs = torch.cat([batch["patches"].to(x_tok.dtype), x_tok], 1)
        prefix_len = cfg.prefix_len
    hidden, slots = forward_hidden(cfg, params, inputs,
                                   prefix_len=prefix_len, enc_out=enc_out,
                                   collect_cache=True, kernels=kernels)
    B, S = inputs.shape[:2]
    max_len = max(max_len, S + 1)
    pad = (0, 0, 0, 0, 0, max_len - S)
    slots = tuple(s._replace(k=F.pad(s.k, pad), v=F.pad(s.v, pad))
                  if layer.spec.kind == "attn" else s
                  for s, layer in zip(slots, params.layers))
    kv_len = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    enc_kv = (enc_out,) if cfg.is_encdec else ()
    return hidden[:, -1], DecodeCache(slots=slots, kv_len=kv_len,
                                      enc_kv=enc_kv)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache: DecodeCache, token,
                kernels=True):
    """token [B] int32 → (logits [B, V] float32, new cache). One serve
    step; the cache's K/V are written in place, the recurrent states
    replaced. An encoder-decoder's cross-attention re-projects
    ``enc_kv[0]`` in every step, as the reference does, with the query
    roped at ``kv_len``."""
    x = common.embed_lookup(params.embed, token)[:, None, :]   # [B, 1, D]
    pos_q = cache.kv_len[:, None]
    new_slots = []
    for i, (layer, slot) in enumerate(zip(params.layers, cache.slots)):
        x, slot = blocks.layer_decode(layer, x, slot, cache.kv_len, cfg,
                                      layer.spec, kernels=kernels)
        if cfg.is_encdec:
            x = cross_attend(cfg, params.cross[i], x, cache.enc_kv[0],
                             pos_q, kernels)
        new_slots.append(slot)
    x = common.rms_norm(x, params.final_ln, cfg.norm_eps)
    logits = lm_head(x[:, 0], params.embed, cfg.logit_softcap)
    return logits, cache._replace(slots=tuple(new_slots),
                                  kv_len=cache.kv_len + 1)
