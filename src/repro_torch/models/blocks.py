"""Per-layer blocks (``repro/models/blocks.py``): GQA attention, MLPs and
the layer over them (attention, mamba, mLSTM or sLSTM, then an MLP, a MoE
or neither), as ``nn.Module``s whose parameter names are the reference's
leaf names, and the reference's functions over them.

Parameter layout (a state-dict key ``layers.{i}.attn.wq`` is the
reference's ``u{p}/attn/wq[u]`` for layer ``i = u·unit_len + p``):
  wq [D, Hq*Dh]   wk/wv [D, Hkv*Dh]   wo [Hq*Dh, D]
  mlp: w_gate/w_in [D, F], w_out [F, D]   (sq_relu: no w_gate)
  moe: router [D, E], w_gate/w_in [E, D, F], w_out [E, F, D]
  mamba, mlstm, slstm: ``models/recurrent.py``

The cross-attention (``init_cross_attn``) is an :class:`Attention`;
:func:`attn_forward` takes its precomputed encoder memory as
``kv_override``.

On the card, :func:`attn_forward` runs the ``flash_attention`` kernel
where the kernel's mask is the call's (:func:`attn_forward` says where),
a mamba layer's prefill the ``mamba_scan`` kernel and a MoE layer's
experts the ``moe_gmm`` kernel; every other call runs the plain
versions. ``kernels=False`` keeps the card on the plain path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common, recurrent
from repro_torch.models.moe import MoE, apply_moe


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ----------------------------------------------------------- attention ----
class Attention(nn.Module):
    """The projections; drawn from ``generator`` when one is given, else
    left uninitialised (for weights loaded afterwards)."""

    def __init__(self, cfg: ArchConfig, dtype, device=None, generator=None):
        super().__init__()
        D, Dh = cfg.d_model, cfg.d_head
        self.wq = _param((D, cfg.n_heads * Dh), dtype, device)
        self.wk = _param((D, cfg.n_kv_heads * Dh), dtype, device)
        self.wv = _param((D, cfg.n_kv_heads * Dh), dtype, device)
        self.wo = _param((cfg.n_heads * Dh, D), dtype, device)
        if generator is not None:
            for w in (self.wq, self.wk, self.wv):
                common.normal_(w, D ** -0.5, generator)
            common.normal_(self.wo, (cfg.n_heads * Dh) ** -0.5, generator)


def init_attn(cfg: ArchConfig, dtype, *, generator, device=None):
    return Attention(cfg, dtype, device, generator)


def prefix_attention(q, k, v, prefix_len: int, *, softcap=None,
                     attend=None):
    """The prefix-LM mask over q [B, S, Hq, D] and k, v [B, S, Hkv, D] at
    the positions ``0..S-1``, without a window, as two calls of
    ``attend`` (by default ``flash_ops.flash_attention``): a causal one
    over all S rows, and a non-causal one over the first P =
    ``prefix_len`` rows and keys, whose output takes those rows' place
    in a new tensor (neither call's output is written over). The
    reference's mask ``(dk <= dq) | (dk < P)`` shows a row below P
    exactly the keys below P and a row at P or above exactly the keys up
    to itself, which the causal call gives it (its mask is aligned at the
    top left, so it runs over all rows)."""
    attend = attend or flash_ops.flash_attention
    o = attend(q, k, v, causal=True, softcap=softcap)
    P = min(prefix_len, q.shape[1])
    if P <= 0:
        return o
    head = attend(*(t[:, :P].contiguous() for t in (q, k, v)),
                  causal=False, softcap=softcap)
    return torch.cat([head, o[:, P:]], dim=1)


def attn_forward(p, x, positions, cfg: ArchConfig, *, window, causal=True,
                 prefix_len=None, kv_override=None, chunk=512, kernels=True):
    """Full-sequence attention (train / prefill). Returns (y, (k, v)).

    ``positions`` [B, S], or None for ``0..S-1`` in every row.
    ``kv_override`` ``(k, v, pos_k)``: the cross-attention's precomputed
    memory, k and v [B, Sk, Hkv, Dh] (not roped) at ``pos_k`` [B, Sk], or
    at ``0..Sk-1`` where ``pos_k`` is None. ``prefix_len``: [B], or a
    Python int for every row.

    On the card the flash kernel runs where the key positions are
    ``0..Sk-1`` (``positions`` None, or ``pos_k`` None under
    ``kv_override``) and the call is causal with ``positions`` None and
    no ``prefix_len``, or causal with an int ``prefix_len``, no window and
    ``positions`` None (:func:`prefix_attention`), or non-causal without
    a window or ``prefix_len`` (positions then enter through rope
    alone)."""
    B, S, D = x.shape
    Dh = cfg.d_head
    arange = positions is None
    if arange:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, Dh)
    if kv_override is None:
        k = (x @ p.wk).reshape(B, S, cfg.n_kv_heads, Dh)
        v = (x @ p.wv).reshape(B, S, cfg.n_kv_heads, Dh)
        k = common.rope(k, positions, cfg.rope_theta)
        pos_k, keys_arange = positions, arange
    else:   # cross-attention: the precomputed encoder memory
        k, v, pos_k = kv_override
        keys_arange = pos_k is None
        if keys_arange:
            Sk = k.shape[1]
            pos_k = torch.arange(Sk, device=x.device)[None].expand(B, Sk)
    q = common.rope(q, positions, cfg.rope_theta)
    card = kernels and x.is_cuda and keys_arange
    cap = cfg.attn_softcap
    if card and causal and arange and prefix_len is None:
        o = flash_ops.flash_attention(q, k, v, causal=True, window=window,
                                      softcap=cap)
    elif card and causal and arange and isinstance(prefix_len, int) \
            and window is None:
        o = prefix_attention(q, k, v, prefix_len, softcap=cap)
    elif card and not causal and window is None and prefix_len is None:
        o = flash_ops.flash_attention(q, k, v, causal=False, softcap=cap)
    else:
        if isinstance(prefix_len, int):
            prefix_len = torch.full((B,), prefix_len, dtype=torch.int32,
                                    device=x.device)
        o = common.chunked_attention(
            q, k, v, positions_q=positions, positions_k=pos_k,
            causal=causal, window=window, prefix_len=prefix_len,
            attn_cap=cap, chunk=min(chunk, k.shape[1]))
    y = o.reshape(B, S, cfg.n_heads * Dh) @ p.wo
    return y, (k, v)


def attn_decode(p, x, k_cache, v_cache, kv_len, cfg: ArchConfig, *, window):
    """One-token decode. x: [B, 1, D]; caches [B, S, Hkv, Dh]; kv_len [B].

    Writes the new K/V at position kv_len (per sequence, in place) then
    attends."""
    B = x.shape[0]
    Dh = cfg.d_head
    pos = kv_len.to(torch.int32)
    q = (x @ p.wq).reshape(B, cfg.n_heads, Dh)
    k = (x @ p.wk).reshape(B, 1, cfg.n_kv_heads, Dh)
    v = (x @ p.wv).reshape(B, 1, cfg.n_kv_heads, Dh)
    k = common.rope(k, pos[:, None], cfg.rope_theta)[:, 0]
    q = common.rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k_cache, v_cache = common.kv_cache_update(k_cache, v_cache, k, v[:, 0],
                                              pos)
    o = common.decode_attention(q, k_cache, v_cache, kv_len + 1,
                                window=window, attn_cap=cfg.attn_softcap)
    y = o.reshape(B, 1, cfg.n_heads * Dh) @ p.wo
    return y, (k_cache, v_cache)


def init_cross_attn(cfg: ArchConfig, dtype, *, generator, device=None):
    return init_attn(cfg, dtype, generator=generator, device=device)


# ----------------------------------------------------------------- MLP ----
class MLP(nn.Module):
    """The gated (or, for ``sq_relu``, ungated) MLP; drawn from
    ``generator`` when one is given."""

    def __init__(self, cfg: ArchConfig, dtype, device=None, generator=None):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        self.w_in = _param((D, F), dtype, device)
        self.w_out = _param((F, D), dtype, device)
        if cfg.activation != "sq_relu":
            self.w_gate = _param((D, F), dtype, device)
        if generator is not None:
            for name, w in self.named_parameters():
                common.normal_(w, (F if name == "w_out" else D) ** -0.5,
                               generator)


def init_mlp(cfg: ArchConfig, dtype, *, generator, device=None):
    return MLP(cfg, dtype, device, generator)


def mlp_forward(p, x, cfg: ArchConfig):
    h = x @ p.w_in
    if cfg.activation == "sq_relu":
        h = common.activate(h, "sq_relu")
    else:
        h = common.activate(x @ p.w_gate, cfg.activation) * h
    return h @ p.w_out


# --------------------------------------------------------- one layer ------
class Layer(nn.Module):
    """One decoder layer: ``ln1``; ``attn``, ``mamba``, ``mlstm`` or
    ``slstm`` by ``spec.kind``; and ``ln2`` with ``mlp`` or ``moe``
    (neither when ``spec.mlp == "none"``). The norm scales start at zero,
    as the reference's; the weights are drawn from ``generator`` when one
    is given."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, dtype, device=None,
                 generator=None):
        super().__init__()
        self.spec = spec
        D = cfg.d_model
        self.ln1 = nn.Parameter(torch.zeros(D, device=device))
        if spec.kind == "attn":
            self.attn = Attention(cfg, dtype, device, generator)
        elif spec.kind == "mamba":
            self.mamba = recurrent.Mamba(D, dtype=dtype, device=device,
                                         generator=generator)
        elif spec.kind == "mlstm":
            self.mlstm = recurrent.MLSTM(D, cfg.n_heads, dtype, device,
                                         generator)
        elif spec.kind == "slstm":
            self.slstm = recurrent.SLSTM(D, cfg.n_heads, dtype, device,
                                         generator)
        if spec.mlp != "none":
            self.ln2 = nn.Parameter(torch.zeros(D, device=device))
        if spec.mlp == "dense":
            self.mlp = MLP(cfg, dtype, device, generator)
        elif spec.mlp == "moe":
            self.moe = MoE(D, cfg.d_ff, cfg.n_experts, dtype, device,
                           generator)


def init_layer(cfg: ArchConfig, spec: LayerSpec, dtype, *, generator,
               device=None) -> Layer:
    return Layer(cfg, spec, dtype, device, generator)


class LayerCacheSlot(NamedTuple):
    """Decode-time cache of ONE layer: K/V for attention, a
    ``MambaCache``, ``MLSTMCache`` or ``SLSTMCache`` for the recurrent
    kinds. Unused fields are () placeholders."""
    k: object = ()
    v: object = ()
    mamba: object = ()
    mlstm: object = ()
    slstm: object = ()


def moe_block(p, x, cfg: ArchConfig, capacity_factor, kernels=True):
    """The MoE half of layer ``p`` on x [B, S, D] (its output, to be added
    to x). The experts use ``apply_moe``'s default activation, SiLU,
    whatever ``cfg.activation`` says, as the reference's blocks call it."""
    B, S, D = x.shape
    h2 = common.rms_norm(x, p.ln2, cfg.norm_eps).reshape(B * S, D)
    y2, _ = apply_moe(p.moe, h2, top_k=cfg.top_k,
                      capacity_factor=capacity_factor, kernels=kernels)
    return y2.reshape(B, S, D)


def _mixer(p, x, positions, cfg: ArchConfig, spec: LayerSpec, prefix_len,
           causal, kernels):
    """The sequence mixer of layer ``p`` on x: ``(y, cache slot)``."""
    h = common.rms_norm(x, p.ln1, cfg.norm_eps)
    slot = LayerCacheSlot()
    if spec.kind == "attn":
        y, (k, v) = attn_forward(p.attn, h, positions, cfg,
                                 window=spec.window, causal=causal,
                                 prefix_len=prefix_len, kernels=kernels)
        slot = slot._replace(k=k, v=v)
    elif spec.kind == "mamba":
        y, mc = recurrent.apply_mamba(p.mamba, h, kernels=kernels)
        slot = slot._replace(mamba=mc)
    elif spec.kind == "mlstm":
        y, mc = recurrent.apply_mlstm(p.mlstm, h, n_heads=cfg.n_heads)
        slot = slot._replace(mlstm=mc)
    else:
        y, sc = recurrent.apply_slstm(p.slstm, h, n_heads=cfg.n_heads)
        slot = slot._replace(slstm=sc)
    return y, slot


def _ffn(p, x, cfg: ArchConfig, spec: LayerSpec, kernels):
    """The MLP or MoE half of layer ``p`` on x (its output)."""
    if spec.mlp == "dense":
        return mlp_forward(p.mlp, common.rms_norm(x, p.ln2, cfg.norm_eps),
                           cfg)
    return moe_block(p, x, cfg, cfg.capacity_factor, kernels)


def checkpointed(fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward pass
    and its output kept."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def layer_forward(p, x, positions, cfg: ArchConfig, spec: LayerSpec, *,
                  prefix_len=None, causal=True, kernels=True,
                  remat_blocks=False):
    """Train/prefill forward of one layer. Returns (x, cache_slot).

    ``remat_blocks`` checkpoints the mixer and the MLP/MoE bodies one by
    one, so that the backward pass keeps their outputs (the reference's
    ``"block_out"``) and recomputes each body alone."""
    run = checkpointed if remat_blocks else (lambda fn, *a: fn(*a))
    y, slot = run(_mixer, p, x, positions, cfg, spec, prefix_len, causal,
                  kernels)
    x = x + y
    if spec.mlp != "none":
        x = x + run(_ffn, p, x, cfg, spec, kernels)
    return x, slot


def layer_decode(p, x, cache: LayerCacheSlot, kv_len, cfg: ArchConfig,
                 spec: LayerSpec, *, kernels=True):
    """One-token decode of one layer. Returns (x, new_cache_slot)."""
    h = common.rms_norm(x, p.ln1, cfg.norm_eps)
    if spec.kind == "attn":
        y, (k, v) = attn_decode(p.attn, h, cache.k, cache.v, kv_len, cfg,
                                window=spec.window)
        cache = cache._replace(k=k, v=v)
    elif spec.kind == "mamba":
        y, mc = recurrent.apply_mamba(p.mamba, h, cache.mamba)
        cache = cache._replace(mamba=mc)
    elif spec.kind == "mlstm":
        y, mc = recurrent.apply_mlstm(p.mlstm, h, cache.mlstm,
                                      n_heads=cfg.n_heads, chunk=1)
        cache = cache._replace(mlstm=mc)
    else:
        y, sc = recurrent.apply_slstm(p.slstm, h, cache.slstm,
                                      n_heads=cfg.n_heads)
        cache = cache._replace(slstm=sc)
    x = x + y
    if spec.mlp == "dense":
        x = x + mlp_forward(p.mlp, common.rms_norm(x, p.ln2, cfg.norm_eps),
                            cfg)
    elif spec.mlp == "moe":
        x = x + moe_block(p, x, cfg, max(2.0, cfg.capacity_factor),
                          kernels)
    return x, cache
