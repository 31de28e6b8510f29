"""The rounding of the bf16 tensor-core routes of flash attention and the
expert FFN, modelled in plain PyTorch on the CPU, and the Python arithmetic
of their launches.

The model: bf16 operands, exact products, float32 sums (what ``wgmma``'s
bf16 inputs and float32 accumulators give), and the second
product of each kernel (P·V, ``a·h``·w_out) taken with its float32 operand
split into two bf16 terms, ``hi = bf16(x)`` and ``lo = bf16(x − hi)``. It
stays within the limits ``chip_smoke.py`` and the card tests hold the
kernels to against the plain version on float32 copies of their inputs
(``F32_PLAIN_RTOL`` of each value plus ``F32_PLAIN_ATOL_RMS`` of the
output's RMS). The same model with one bf16 rounding of that operand
falls outside them: the reason for the split.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.kernels.moe_gmm.ref import act_and_up, moe_gmm_ref
from repro_torch.kernels.tolerance import F32_PLAIN_ATOL_RMS, F32_PLAIN_RTOL

from test_torch_gpu import MOE_CASES, TC_MOE_CASE


def _bf16_values(a):
    """A float32 tensor of the bf16 values nearest to ``a``."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float()


def _split(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _second_operand(x, split):
    """The terms the kernel feeds its second product: hi and lo, or one
    bf16 rounding."""
    return _split(x) if split else (x.bfloat16().float(),)


def _outside(out, plain32):
    """The share of elements beyond the float32 plain version's limit."""
    lim = F32_PLAIN_RTOL * plain32.abs() \
        + F32_PLAIN_ATOL_RMS * plain32.pow(2).mean().sqrt()
    return float(((out.float() - plain32).abs() > lim).float().mean())


def attention_model(q, k, v, *, causal, window, softcap, split):
    """q: [B, S, Hq, D], k, v: [B, S, Hkv, D], bf16 values in float32.
    Scores from exact products summed in float32, × scale, softcap, mask,
    softmax in float32; P·V over the terms of P; output rounded to bf16."""
    S, Hq, D = q.shape[1:]
    g = Hq // k.shape[2]
    kk, vv = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * D ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp, kp = torch.arange(S)[:, None], torch.arange(S)[None]
    vis = torch.ones(S, S, dtype=torch.bool)
    if causal:
        vis &= kp <= qp
    if window is not None:
        vis &= qp - kp < window
    s = s.masked_fill(~vis, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = sum(torch.einsum("bhqk,bkhd->bqhd", t, vv)
            for t in _second_operand(p, split))
    return (o / p.sum(-1)[..., None].transpose(1, 2)).bfloat16()


def ffn_model(x, wg, wi, wo, *, activation, split):
    """Gate and up products summed in float32, the activation in float32,
    the down product over the terms of ``a·h``; output rounded to bf16."""
    ah = act_and_up(x @ wg, x @ wi, activation)
    return sum(t @ wo for t in _second_operand(ah, split)).bfloat16()


# B, S, Hq, Hkv, D, causal, window, softcap
ATTN_CASES = [(1, 256, 2, 1, 64, True, None, None),
              (1, 384, 4, 2, 64, True, 100, 50.0),
              (1, 256, 2, 2, 128, False, None, None)]


def _attn_inputs(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.RandomState(seed)
    return (_bf16_values(rng.randn(B, S, Hq, D)),
            _bf16_values(rng.randn(B, S, Hkv, D)),
            _bf16_values(rng.randn(B, S, Hkv, D)))


def _ffn_inputs(E, C, D, F, seed=0):
    """x ~ N(0, 1), weights scaled by fan-in^-0.5, as chip_smoke.py's M1."""
    rng = np.random.RandomState(seed)
    return (_bf16_values(rng.randn(E, C, D)),
            _bf16_values(rng.randn(E, D, F) * D ** -0.5),
            _bf16_values(rng.randn(E, D, F) * D ** -0.5),
            _bf16_values(rng.randn(E, F, D) * F ** -0.5))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_split_keeps_f32_plain_limits(case):
    B, S, Hq, Hkv, D, causal, window, softcap = case
    q, k, v = _attn_inputs(B, S, Hq, Hkv, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    plain32 = flash_attention_ref(q, k, v, **kw)
    assert _outside(attention_model(q, k, v, split=True, **kw), plain32) == 0


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_single_rounding_of_p_fails_f32_plain_limits(case):
    B, S, Hq, Hkv, D, causal, window, softcap = case
    q, k, v = _attn_inputs(B, S, Hq, Hkv, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    plain32 = flash_attention_ref(q, k, v, **kw)
    assert _outside(attention_model(q, k, v, split=False, **kw),
                    plain32) > 0.005


@pytest.mark.parametrize("activation", list(moe_ops.ACTIVATIONS))
def test_ffn_split_keeps_f32_plain_limits(activation):
    args = _ffn_inputs(2, 64, 128, 512)
    plain32 = moe_gmm_ref(*args, activation=activation)
    assert _outside(ffn_model(*args, activation=activation, split=True),
                    plain32) == 0


@pytest.mark.parametrize("activation", list(moe_ops.ACTIVATIONS))
def test_ffn_single_rounding_of_ah_fails_f32_plain_limits(activation):
    args = _ffn_inputs(2, 64, 128, 512)
    plain32 = moe_gmm_ref(*args, activation=activation)
    assert _outside(ffn_model(*args, activation=activation, split=False),
                    plain32) > 0.005


def test_split_terms_sum_to_the_value():
    """hi + lo is x to within 2^-16 of |x| (hi alone: 2^-8)."""
    x = torch.from_numpy(np.random.RandomState(1).rand(4096)
                         .astype(np.float32))
    hi, lo = _split(x)
    assert float(((hi + lo - x).abs() / x).max()) <= 2.0 ** -16
    assert float(((hi - x).abs() / x).max()) > 2.0 ** -12


# ------------------------------------------------- launch arithmetic ----
@pytest.mark.parametrize("D", flash_ops.HEAD_DIMS)
def test_flash_bf16_tiles_and_shared_memory(D):
    bq, bk = flash_ops.tc_tiles(D)
    assert (bq, bk) == (128, 64 if D <= 128 else 32)
    assert bq % 64 == 0 and bk % 16 == 0       # 64-row groups, 16-key MMAs
    stages = flash_ops.TC_STAGES
    smem = flash_ops.tc_smem_bytes(D)
    barriers_and_slack = 8 * (1 + 3 * stages) + 1024
    assert smem == 2 * D * (bq + 2 * stages * bk) + barriers_and_slack
    assert smem <= _cuda.MAX_SMEM
    assert stages >= 2


@pytest.mark.parametrize("activation", list(moe_ops.ACTIVATIONS))
def test_moe_bf16_shared_memory(activation):
    bm, bn, bk = moe_ops.TC_TILE
    stages = moe_ops.TC_STAGES
    up = moe_ops.tc_smem_bytes(activation, down=False)
    down = moe_ops.tc_smem_bytes(activation, down=True)
    n_b = 1 if activation == "sq_relu" else 2
    barriers_and_slack = 16 * stages + 1024
    assert up == 2 * stages * (bm * bk + n_b * bk * bn) + barriers_and_slack
    assert down == 2 * stages * (2 * bm * bk + bk * bn) + barriers_and_slack
    assert max(up, down) <= _cuda.MAX_SMEM
    assert stages >= 3                  # two in flight, one being read
    assert bk * 2 == 128                # a row of a tile is one swizzle row


@pytest.mark.parametrize("D, F", [(6144, 16384), (256, 512),
                                  TC_MOE_CASE[2:]]
                         + [case[2:4] for case in MOE_CASES])
def test_moe_alignment_accepts_config_and_sweep_widths(D, F):
    moe_ops.check_alignment(D, F)


@pytest.mark.parametrize("D, F", [(16, 20), (20, 16), (6144, 16388)])
def test_moe_alignment_refuses_misaligned_widths(D, F):
    with pytest.raises(ValueError, match="multiples of 8"):
        moe_ops.check_alignment(D, F)
