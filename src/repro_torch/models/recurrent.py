"""Recurrent blocks (``repro/models/recurrent.py``): the Mamba selective
SSM (jamba) and xLSTM's mLSTM and sLSTM cells, as ``nn.Module``s whose
parameter names are the reference's leaf names, and the reference's
functions over them.

Leaves the reference keeps in float32 whatever the model's dtype
(``dt_bias``, ``A_log``, ``D_skip``, ``w_if``, ``r``, ``bias``, ``ln``) are
float32 here too, so that loading its weights rounds nothing.
``A_log``, ``D_skip`` and ``dt_bias`` are set as the reference sets them,
drawn or not; mLSTM's ``ln`` is a leaf that ``apply_mlstm`` never reads.

On the card, a Mamba layer's prefill (``apply_mamba`` without a cache,
``kernels=True``) runs its selective scan as the ``mamba_scan`` kernel on
float32 copies of dt, x, B and C, which also returns the last state the
decode cache holds; every other call (decode, a given cache, the CPU)
runs its plain version from the cache's state (``mamba_scan_ref``: the
reference's discretisation and :func:`linear_rnn`).

mLSTM is the reference's chunked function, not the plain recurrence: its
result depends on the chunk (the stabiliser is floored at -30 a chunk and
``h`` is divided by ``max(|den|, 1)`` at the scale that sets), so prefill
runs chunks of 64 and decode chunks of 1, as there.

The reference's ``apply_slstm`` constrains its pre-activations' sharding
over a device mesh (``repro.policy.recurrent_local``); one card has no
mesh, so that branch has no counterpart here.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan import ref as mamba_ref
from repro_torch.models import common


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


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Mamba (selective SSM) — jamba's sequence mixer
# ---------------------------------------------------------------------------
class Mamba(nn.Module):
    """``in_proj`` [D, 2·Di], ``conv_w`` [d_conv, Di], ``x_proj`` [Di, R +
    2N], ``dt_proj`` [R, Di], ``out_proj`` [Di, D] in ``dtype`` (drawn
    from ``generator`` when one is given); ``dt_bias`` (zeros), ``A_log``
    (log 1..N on every channel) and ``D_skip`` (ones), float32."""

    def __init__(self, d_model: int, *, expand: int = 2, d_state: int = 16,
                 d_conv: int = 4, dt_rank=None, dtype=torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        di = expand * d_model
        dt_rank = dt_rank or max(1, d_model // 16)
        self.in_proj = _param((d_model, 2 * di), dtype, device)
        self.conv_w = _param((d_conv, di), dtype, device)
        self.x_proj = _param((di, dt_rank + 2 * d_state), dtype, device)
        self.dt_proj = _param((dt_rank, di), dtype, device)
        self.dt_bias = nn.Parameter(torch.zeros(di, device=device))
        self.A_log = nn.Parameter(torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32, device=device)).repeat(di, 1))
        self.D_skip = nn.Parameter(torch.ones(di, device=device))
        self.out_proj = _param((di, d_model), dtype, device)
        if generator is not None:
            for w, std in ((self.in_proj, d_model ** -0.5),
                           (self.conv_w, 0.2), (self.x_proj, di ** -0.5),
                           (self.dt_proj, dt_rank ** -0.5),
                           (self.out_proj, di ** -0.5)):
                common.normal_(w, std, generator)


def init_mamba(d_model: int, *, generator, expand: int = 2,
               d_state: int = 16, d_conv: int = 4, dt_rank=None,
               dtype=torch.bfloat16, device=None) -> Mamba:
    """A Mamba layer drawn from ``generator`` on ``device`` (the card
    unless the CPU is asked for)."""
    return Mamba(d_model, expand=expand, d_state=d_state, d_conv=d_conv,
                 dt_rank=dt_rank, dtype=dtype,
                 device=resolve_device(device), generator=generator)


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, Di] — trailing inputs for the conv
    ssm: torch.Tensor    # [B, Di, N] — SSM hidden state, float32


def mamba_init_cache(batch: int, p, dtype=torch.float32) -> MambaCache:
    di = p.dt_proj.shape[1]
    n = p.A_log.shape[1]
    dc = p.conv_w.shape[0]
    dev = p.A_log.device
    return MambaCache(conv=torch.zeros((batch, dc - 1, di), dtype=dtype,
                                       device=dev),
                      ssm=torch.zeros((batch, di, n), dtype=torch.float32,
                                      device=dev))


def _mamba_core(p, xz, conv_state, ssm_state, *, scan_kernel=False):
    """Shared prefill/decode core. xz: [B, S, 2·Di]. ``scan_kernel`` runs
    the scan through the ``mamba_scan`` entry point (the kernel on the
    card, its plain version on the CPU) on float32 dt, x, B and C; the
    kernel starts from a zero state, so ``ssm_state`` must be zero then.
    """
    B, S, _ = xz.shape
    x, z = xz.chunk(2, dim=-1)
    # causal depthwise conv (width d_conv) with carried state: the
    # reference's sum of d_conv products in x's dtype, from i = 0
    dc = p.conv_w.shape[0]
    xc = torch.cat([conv_state.to(x.dtype), x], dim=1)
    new_conv = xc[:, -(dc - 1):, :].clone()   # not a view that keeps xc
    x = xc[:, 0:S, :] * p.conv_w[0][None, None, :]
    for i in range(1, dc):
        x = x + xc[:, i:i + S, :] * p.conv_w[i][None, None, :]
    x = F.silu(x)

    proj = x @ p.x_proj                                  # [B, S, R+2N]
    n_state = p.A_log.shape[1]
    dt_r = proj[..., : -2 * n_state]
    Bm = proj[..., -2 * n_state: -n_state]               # [B, S, N]
    Cm = proj[..., -n_state:]
    dt = F.softplus((dt_r @ p.dt_proj).float()
                    + p.dt_bias[None, None, :])          # [B, S, Di] f32
    # the scan on float32 dt, x, B and C: the kernel from a zero state,
    # or its plain version from ``ssm_state``
    scan = (mamba_ops.mamba_scan if scan_kernel else
            functools.partial(mamba_ref.mamba_scan_ref, h0=ssm_state))
    y, h_last = scan(dt, x.float(), Bm.float().contiguous(),
                     Cm.float().contiguous(), p.A_log, p.D_skip,
                     return_state=True)
    y = y * F.silu(z).float()
    return (y @ p.out_proj.float()).to(xz.dtype), MambaCache(new_conv,
                                                             h_last)


def apply_mamba(p, x, cache: MambaCache | None = None, *, kernels=True):
    """x: [B, S, D] → (y [B, S, D], new_cache). A CUDA call without a
    cache runs the scan as the ``mamba_scan`` kernel unless ``kernels`` is
    False."""
    scan_kernel = kernels and x.is_cuda and cache is None
    if cache is None:
        cache = mamba_init_cache(x.shape[0], p)
    xz = x @ p.in_proj
    return _mamba_core(p, xz, cache.conv, cache.ssm, scan_kernel=scan_kernel)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory cell), chunked parallel form
# ---------------------------------------------------------------------------
class MLSTM(nn.Module):
    """``wq``, ``wk``, ``wv``, ``w_o``, ``out`` [D, D] in ``dtype``;
    ``w_if`` [D, 2H] and ``ln`` [D] (zeros, unused) float32."""

    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        D = d_model
        self.wq = _param((D, D), dtype, device)
        self.wk = _param((D, D), dtype, device)
        self.wv = _param((D, D), dtype, device)
        self.w_if = _param((D, 2 * n_heads), torch.float32, device)
        self.w_o = _param((D, D), dtype, device)
        self.out = _param((D, D), dtype, device)
        self.ln = nn.Parameter(torch.zeros(D, device=device))
        if generator is not None:
            for w in (self.wq, self.wk, self.wv, self.w_if, self.w_o,
                      self.out):
                common.normal_(w, D ** -0.5, generator)


def init_mlstm(d_model: int, n_heads: int, dtype=torch.bfloat16, *,
               generator, device=None) -> MLSTM:
    """An mLSTM layer drawn from ``generator`` on ``device`` (the card
    unless the CPU is asked for)."""
    return MLSTM(d_model, n_heads, dtype, resolve_device(device), generator)


class MLSTMCache(NamedTuple):
    C: torch.Tensor   # [B, H, Dh, Dh] matrix memory
    n: torch.Tensor   # [B, H, Dh] normalizer
    m: torch.Tensor   # [B, H] gate stabilizer (log-space)


def mlstm_init_cache(batch, n_heads, d_head, device=None) -> MLSTMCache:
    """The zero state on ``device`` (the card unless the CPU is asked
    for)."""
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return MLSTMCache(C=torch.zeros((batch, n_heads, d_head, d_head), **f32),
                      n=torch.zeros((batch, n_heads, d_head), **f32),
                      m=torch.full((batch, n_heads), -30.0, **f32))


def _log_sigmoid(g):
    return -F.softplus(-g)


def apply_mlstm(p, x, cache: MLSTMCache | None = None, *, n_heads: int,
                chunk: int = 64):
    """Chunked mLSTM with exponential gating + log-space stabilization.

    Within a chunk: quadratic decay-masked attention (exact); across
    chunks the (C, n, m) state is carried. Decode (S == 1, chunk 1) is the
    exact recurrence."""
    B, S, D = x.shape
    H = n_heads
    Dh = D // H
    if cache is None:
        cache = mlstm_init_cache(B, H, Dh, x.device)

    def heads(t):
        return t.reshape(B, S, H, Dh).transpose(1, 2)    # [B, H, S, Dh]

    q = heads(x @ p.wq)
    k = heads(x @ p.wk) * Dh ** -0.5
    v = heads(x @ p.wv)
    gates = (x.float() @ p.w_if).reshape(B, S, H, 2)
    log_i = _log_sigmoid(gates[..., 0]).transpose(1, 2)  # [B, H, S]
    log_f = _log_sigmoid(gates[..., 1]).transpose(1, 2)

    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    qp, kp, vp = (F.pad(t, (0, 0, 0, pad)).float() for t in (q, k, v))
    lip = F.pad(log_i, (0, pad), value=-30.0)
    lfp = F.pad(log_f, (0, pad))
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    C, n, m = cache
    hs = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc, li, lf = qp[:, :, sl], kp[:, :, sl], vp[:, :, sl], \
            lip[..., sl], lfp[..., sl]
        csum_f = torch.cumsum(lf, dim=-1)            # Σ log f within chunk
        # decay from the state to position t: csum_f[t]; between s < t:
        # csum_f[t] - csum_f[s] + log_i[s]
        d_state = csum_f + m[..., None]              # [B, H, c]
        d_intra = csum_f[..., :, None] - csum_f[..., None, :] \
            + li[..., None, :]                       # [B, H, c(t), c(s)]
        d_intra = torch.where(causal, d_intra, -torch.inf)
        m_new = torch.maximum(d_intra.amax(dim=-1), d_state)
        m_new = torch.clamp(m_new, min=-30.0)
        w_intra = torch.exp(d_intra - m_new[..., None])
        w_state = torch.exp(d_state - m_new)

        s_qk = torch.einsum("bhtd,bhsd->bhts", qc, kc)
        sw = s_qk * w_intra
        num_intra = torch.einsum("bhts,bhsd->bhtd", sw, vc)
        num_state = torch.einsum("bhtd,bhde->bhte", qc, C) \
            * w_state[..., None]
        den = torch.einsum("bhtd,bhd->bht", qc, n) * w_state + sw.sum(-1)
        hs.append((num_intra + num_state)
                  / torch.clamp(den.abs()[..., None], min=1.0))
        # ---- state update to the end of the chunk ----
        tot_f = csum_f[..., -1]                      # [B, H]
        m_end = torch.maximum(tot_f + m, (tot_f[..., None] - csum_f
                                          + li).amax(dim=-1))
        m_end = torch.clamp(m_end, min=-30.0)
        w_c = torch.exp(tot_f + m - m_end)           # old C scale
        w_k = torch.exp(tot_f[..., None] - csum_f + li - m_end[..., None])
        kw = kc * w_k[..., None]
        C = C * w_c[..., None, None] + torch.einsum("bhsd,bhse->bhde", kw,
                                                    vc)
        n = n * w_c[..., None] + kw.sum(dim=2)
        m = m_end
    h = torch.cat(hs, dim=2)[:, :, :S]               # [B, H, S, Dh]
    h = h.transpose(1, 2).reshape(B, S, D)
    o = torch.sigmoid(x @ p.w_o)
    y = (h.to(x.dtype) * o) @ p.out
    return y, MLSTMCache(C=C, n=n, m=m)


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory cell with recurrent gate connections)
# ---------------------------------------------------------------------------
class SLSTM(nn.Module):
    """``w_in`` [D, 4D] and ``out`` [D, D] in ``dtype``; the block-diagonal
    recurrent weights ``r`` [H, Dh, 4Dh] and ``bias`` [4D] (zeros)
    float32."""

    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        D = d_model
        dh = D // n_heads
        self.w_in = _param((D, 4 * D), dtype, device)
        self.r = _param((n_heads, dh, 4 * dh), torch.float32, device)
        self.bias = nn.Parameter(torch.zeros(4 * D, device=device))
        self.out = _param((D, D), dtype, device)
        if generator is not None:
            for w, std in ((self.w_in, D ** -0.5), (self.r, dh ** -0.5),
                           (self.out, D ** -0.5)):
                common.normal_(w, std, generator)


def init_slstm(d_model: int, n_heads: int, dtype=torch.bfloat16, *,
               generator, device=None) -> SLSTM:
    """An sLSTM layer drawn from ``generator`` on ``device`` (the card
    unless the CPU is asked for)."""
    return SLSTM(d_model, n_heads, dtype, resolve_device(device), generator)


class SLSTMCache(NamedTuple):
    c: torch.Tensor   # [B, D]
    n: torch.Tensor   # [B, D]
    h: torch.Tensor   # [B, D]
    m: torch.Tensor   # [B, D] stabilizer


def slstm_init_cache(batch, d_model, device=None) -> SLSTMCache:
    """The zero state on ``device`` (the card unless the CPU is asked
    for)."""
    z = torch.zeros((batch, d_model), dtype=torch.float32,
                    device=resolve_device(device))
    return SLSTMCache(c=z, n=z, h=z, m=z - 30.0)


def apply_slstm(p, x, cache: SLSTMCache | None = None, *, n_heads: int):
    """Strictly sequential scan (recurrent gate connections), exp gating
    with the xLSTM stabilizer. x: [B, S, D]."""
    B, S, D = x.shape
    H = n_heads
    Dh = D // H
    if cache is None:
        cache = slstm_init_cache(B, D, x.device)
    pre_all = (x @ p.w_in).float() + p.bias[None, None]     # [B, S, 4D]
    c, n, h, m = cache
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hdk->bhk", h.reshape(B, H, Dh),
                           p.r).reshape(B, 4 * D)
        # z, i, f, o: four contiguous D-blocks of the flattened [B, 4D]
        z_, i_, f_, o_ = (pre_all[:, t] + rec).chunk(4, dim=-1)
        z = torch.tanh(z_)
        o = torch.sigmoid(o_)
        m_new = torch.maximum(f_ + m, i_)
        i = torch.exp(i_ - m_new)
        f = torch.exp(f_ + m - m_new)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp(n.abs(), min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype) @ p.out
    return y, SLSTMCache(c=c, n=n, h=h, m=m)
