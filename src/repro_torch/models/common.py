"""Shared model primitives (``repro/models/common.py``): norms, RoPE,
activations, the embedding lookup, the one-card KV cache write, logit
softcap, the online-softmax step, chunked attention, decode attention and
the chunked cross-entropy of the train loss.

The attention functions are also the plain versions the attention kernels
are held against, so they keep the reference's numerics: the query is
scaled in its own dtype, the scores of a bfloat16 product are rounded to
bfloat16 before they are widened, and the softmax and the value sum run in
float32.

The reference's ``pin`` and ``pin_batch`` constrain shardings over a
device mesh, and ``name_for_remat`` tags a tensor for a
``save_only_these_names`` remat policy; the port keeps the tagged block
outputs by checkpointing each block's body on its own
(``blocks.layer_forward(remat_blocks=True)``), and a sharding constraint
changes no value, so all three are the identity here. ``_mesh_axes``,
``_dp`` and ``_axis_size`` read the live shape-only mesh
(``launch/mesh.py``) as the reference's read ``thread_resources``;
``moe.apply_moe`` selects its sharded dispatch by them. The sharded
branches of ``embed_lookup`` and ``kv_cache_update`` compute the values
of their one-card branches (the reference's ``_policy_equiv_check.py``
holds them to exact equality), so the port keeps only those, and
``chunked_cross_entropy`` its branch without ``ce_vocab_sharded``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as launch_mesh

NEG_INF = -1e30


def normal_(w, std: float, generator):
    """Fill parameter ``w`` in place with N(0, std²) draws from
    ``generator`` (random initialisation; the reference's ``init_*``
    draws from a JAX key instead)."""
    with torch.no_grad():
        w.normal_(0.0, std, generator=generator)
    return w


def _mesh_axes():
    """The live mesh's axis names, or None without one."""
    m = launch_mesh.current()
    return None if m is None else m.axis_names


def _dp(axes):
    return ("pod", "data") if "pod" in axes else "data"


def _axis_size(name) -> int:
    """Product of the live mesh's axis sizes for a name or tuple of names
    (1 without a mesh)."""
    m = launch_mesh.current()
    return 1 if m is None else m.size_of(name)


def pin(x, spec_fn):
    """The identity: a sharding constraint changes no value, and one card
    holds every shard."""
    return x


def pin_batch(x):
    """The identity, as :func:`pin`."""
    return x


def name_for_remat(x, name: str):
    """The identity: no remat policy of the port saves tensors by name
    (module docstring)."""
    return x


def embed_lookup(embed, tokens):
    """``embed[tokens]``: token ids [...] → embeddings [..., D]."""
    return embed[tokens.long()]


def kv_cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Decode-step KV write at per-sequence positions, in place.

    k_cache/v_cache: [B, S, Hkv, Dh]; k_new/v_new: [B, Hkv, Dh]; pos: [B].
    A position past the cache is dropped, as the reference's scatter drops
    it: such a row writes its own old value back. Returns the caches.
    """
    B, S = k_cache.shape[0], k_cache.shape[1]
    b = torch.arange(B, device=k_cache.device)
    p = pos.long()
    p = torch.where(p < 0, p + S, p)
    ok = ((p >= 0) & (p < S))[:, None, None]
    p = p.clamp(0, S - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[b, p] = torch.where(ok, new.to(cache.dtype), cache[b, p])
    return k_cache, v_cache


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta: float = 1e4):
    """Rotary embedding. x: [..., S, H, D]; positions: [..., S]. The
    angles are float32; the result has x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None, None].float() * freq  # [.., S, 1, half]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def activate(x, kind: str):
    """``gelu`` is the tanh approximation, ``jax.nn.gelu``'s default."""
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "sq_relu":   # nemotron-4: squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def softcap(logits, cap: Optional[float]):
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _attend_block(q, k, v, bias, m_prev, l_prev, o_prev, attn_cap):
    """One online-softmax step. q:[B,H,Q,D] k,v:[B,H,C,D] bias:[B,1|H,Q,C]."""
    s = torch.einsum("bhqd,bhcd->bhqc", q, k).float()
    s = softcap(s, attn_cap) + bias
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(dim=-1)
    o_new = o_prev * corr[..., None] \
        + torch.einsum("bhqc,bhcd->bhqd", p, v.float())
    return m_new, l_new, o_new


def chunked_attention(q, k, v, *, positions_q, positions_k, causal: bool,
                      window: Optional[int] = None, prefix_len=None,
                      attn_cap: Optional[float] = None, chunk: int = 512,
                      scale: Optional[float] = None):
    """Online-softmax attention with GQA, sliding window, prefix-LM masks.

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] (Hq % Hkv == 0). ``window``:
    keys within ``window`` of the query position. ``prefix_len``: [B] —
    keys with pos < prefix_len are visible to every query. Keys are taken
    ``chunk`` at a time. A query row that sees no key gets the reference's
    answer: every key, padding included, weighted alike.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qh = (q * scale).transpose(1, 2).reshape(B, Hkv, g * Sq, D)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)

    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    kh = torch.nn.functional.pad(kh, (0, 0, 0, pad))
    vh = torch.nn.functional.pad(vh, (0, 0, 0, pad))
    pk = torch.nn.functional.pad(positions_k, (0, pad), value=-10 ** 9)

    dev = q.device
    m = torch.full((B, Hkv, g * Sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, g * Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Hkv, g * Sq, D), dtype=torch.float32, device=dev)
    dq = positions_q[:, None, :, None]                # [B,1,Sq,1]
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        dk = pk[:, None, None, sl]                    # [B,1,1,chunk]
        ok = dk > -10 ** 8
        vis = dk <= dq if causal else torch.ones_like(dk <= dq)
        if window is not None:
            vis = vis & (dq - dk < window)
        if prefix_len is not None:
            vis = vis | (dk < prefix_len[:, None, None, None])
        bias = torch.where(vis & ok, 0.0, NEG_INF).float()
        bias = bias.expand(B, 1, Sq, chunk)[:, :, None] \
            .expand(B, 1, g, Sq, chunk).reshape(B, 1, g * Sq, chunk)
        m, l, o = _attend_block(qh, kh[:, :, sl], vh[:, :, sl], bias, m, l,
                                o, attn_cap)
    o = o / torch.clamp(l[..., None], min=1e-30)
    o = o.reshape(B, Hq, Sq, D)
    return o.transpose(1, 2).to(q.dtype)             # [B,Sq,Hq,D]


def decode_attention(q, k_cache, v_cache, kv_len, *, window=None,
                     attn_cap=None, scale=None, sink_len: int = 0):
    """Single-token decode attention over a KV cache.

    q: [B, Hq, D]; k_cache/v_cache: [B, S, Hkv, D]; kv_len: [B] valid
    length. Returns [B, Hq, D]. Window masking keeps only the trailing
    ``window`` positions (plus ``sink_len`` leading sink tokens when set).
    A sequence that sees no position (``kv_len = 0``) gets the reference's
    answer: the plain average of its cache rows.
    """
    B, Hq, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qh = (q * scale).reshape(B, Hkv, g, D)
    pos = torch.arange(S, device=q.device)[None, :]   # [1,S]
    vis = pos < kv_len[:, None]
    if window is not None:
        in_win = pos >= (kv_len[:, None] - window)
        if sink_len:
            in_win = in_win | (pos < sink_len)
        vis = vis & in_win
    dt = torch.promote_types(q.dtype, k_cache.dtype)   # JAX's promotion
    s = torch.einsum("bkgd,bskd->bkgs", qh.to(dt), k_cache.to(dt)).float()
    s = softcap(s, attn_cap)
    s = torch.where(vis[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype).to(dt), v_cache.to(dt))
    return o.reshape(B, Hq, D)


def chunked_cross_entropy(hidden, emb, targets, mask, *, chunk: int = 1024,
                          logit_cap: Optional[float] = None):
    """Cross-entropy without materializing [B, S, V] logits.

    hidden: [B, S, D]; emb: [V, D] (the tied head); targets: [B, S]
    int32; mask: [B, S]. The sequence is padded to whole chunks of
    ``chunk`` (padding rows have mask 0 and add nothing); each chunk's
    logits [B, chunk, V] are the product of ``hidden`` and ``emb`` in
    their own dtype, widened to float32, then softcapped; the loss of a
    position is its logsumexp less its target's logit. Returns
    ``(loss_sum / max(w_sum, 1), w_sum)``, the mean and the total
    weight, as the reference's scan returns them."""
    B, S, D = hidden.shape
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    h = F.pad(hidden, (0, 0, 0, pad))
    t = F.pad(targets, (0, pad)).long()
    m = F.pad(mask, (0, pad))
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = torch.einsum("bsd,vd->bsv", h[:, sl], emb).float()
        logits = softcap(logits, logit_cap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, t[:, sl, None], dim=-1)[..., 0]
        mc = m[:, sl]
        loss_sum = loss_sum + ((lse - gold) * mc).sum()
        w_sum = w_sum + mc.sum()
    return loss_sum / torch.clamp(w_sum, min=1.0), w_sum
