"""The port's LM kernel modules against the reference's.

On the CPU the port's plain versions (``repro_torch.kernels.*.ref``, and
the model functions they delegate to) are held against the reference's
``ref.py`` at the sweep shapes and tolerances of ``tests/test_kernels.py``,
in float32 and bfloat16, and once per kernel against the reference's Pallas
kernel in interpret mode. The inputs are float32 numpy arrays made from a
seed by ``test_torch_gpu.py`` (whose card-only tests hold the CUDA kernels
against the same plain versions), rounded to bfloat16 by JAX and carried
across with ``convert.tensor_from_numpy``.

Where the reference's Pallas kernel and its ``ref.py`` disagree (three
inputs, tested below), the port's plain version follows ``ref.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import flash_attention_ref as \
    jflash_ref
from repro.kernels.mamba_scan.ops import mamba_scan as jmamba
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jmamba_ref
from repro.kernels.moe_gmm.ops import moe_gmm as jmoe
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jmoe_ref
from repro.kernels.paged_attention.ops import paged_attention as jpaged
from repro.kernels.paged_attention.ref import paged_attention_ref as \
    jpaged_ref
from repro.models import common as jcommon
from repro.models import recurrent as jrecurrent
from repro.serve import kvcache as jkvc

from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.tolerance import LM_TOL, MAMBA_TOL
from repro_torch.models import common, recurrent
from repro_torch.serve import kvcache

from test_torch_gpu import (FLASH_CASES, LM_DTYPES, MAMBA_CASES, MOE_CASES,
                            NO_KEY_ROWS, PAGED_CASES, flash_inputs,
                            flash_visible_rows, mamba_inputs, moe_inputs,
                            paged_inputs)


def _pair(a, dtype="float32"):
    """``a`` in ``dtype`` as a JAX array and as a port tensor, the same
    bits in both."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, tensor_from_numpy(np.asarray(j))


def _pairs(arrays, dtype="float32"):
    pairs = [_pair(a, dtype) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _close(port, ref, tol, what=""):
    np.testing.assert_allclose(tensor_to_numpy(port),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


# ------------------------------------------------------------- flash -------
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_reference(case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap = case
    (jq, jk, jv), (q, k, v) = _pairs(flash_inputs(B, Sq, Sk, Hq, Hkv, D),
                                     dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    port = flash_attention_ref(q, k, v, **kw)
    assert port.dtype == q.dtype and port.shape == q.shape
    _close(port, jflash_ref(jq, jk, jv, **kw), LM_TOL[dtype])


def test_flash_plain_matches_pallas_interpret():
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap = FLASH_CASES[2]
    (jq, jk, jv), (q, k, v) = _pairs(flash_inputs(B, Sq, Sk, Hq, Hkv, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    ker = jflash(jq, jk, jv, bq=32, bk=32, interpret=True, **kw)
    _close(flash_attention_ref(q, k, v, **kw), ker, LM_TOL["float32"])


def test_flash_rows_without_keys_follow_reference():
    """Sq=40, Sk=24, window 5, causal: rows 28-39 see no key. There the
    port's plain version equals the reference's ``ref.py`` (an average of
    every key, padding included). The reference's Pallas kernel differs on
    such rows, by an amount that depends on its ``bk`` (ROADMAP Queue 3);
    on every row that sees a key all three agree."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, _ = NO_KEY_ROWS
    (jq, jk, jv), (q, k, v) = _pairs(flash_inputs(B, Sq, Sk, Hq, Hkv, D))
    ref = np.asarray(jflash_ref(jq, jk, jv, causal=causal, window=window))
    port = flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(port, ref, LM_TOL["float32"])
    seen = flash_visible_rows(Sq, Sk, causal, window)
    assert seen[:28].all() and not seen[28:].any()
    ker = np.asarray(jflash(jq, jk, jv, causal=causal, window=window, bq=8,
                            bk=8, interpret=True))
    np.testing.assert_allclose(ker[:, seen], ref[:, seen], rtol=2e-5,
                               atol=2e-5)
    assert np.abs(ker[:, ~seen] - ref[:, ~seen]).max() > 0.1


def test_chunked_attention_prefix_len_matches_reference():
    """Several chunks, GQA, a window and a softcap, with a prefix-LM
    prefix that every query sees."""
    rng = np.random.RandomState(7)
    B, Sq, Sk, Hq, Hkv, D = 2, 24, 40, 4, 2, 16
    (jq, jk, jv), (q, k, v) = _pairs(
        [rng.randn(B, Sq, Hq, D), rng.randn(B, Sk, Hkv, D),
         rng.randn(B, Sk, Hkv, D)])
    pq = np.tile(np.arange(16, 16 + Sq, dtype=np.int32), (B, 1))
    pk = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    prefix = np.array([5, 12], np.int32)
    kw = dict(causal=True, window=6, attn_cap=20.0, chunk=16, scale=0.3)
    ref = jcommon.chunked_attention(
        jq, jk, jv, positions_q=jnp.asarray(pq), positions_k=jnp.asarray(pk),
        prefix_len=jnp.asarray(prefix), **kw)
    port = common.chunked_attention(
        q, k, v, positions_q=torch.from_numpy(pq),
        positions_k=torch.from_numpy(pk), prefix_len=torch.from_numpy(prefix),
        **kw)
    _close(port, ref, LM_TOL["float32"])


# ------------------------------------------------------------- paged -------
def _paged_pairs(case, dtype="float32", pt=None, kv_len=None):
    q, kp, vp, pt0, kl0 = paged_inputs(*case[:3])
    (jq, jkp, jvp), (tq, tkp, tvp) = _pairs([q, kp, vp], dtype)
    pt = pt0 if pt is None else np.asarray(pt, np.int32)
    kl = kl0 if kv_len is None else np.asarray(kv_len, np.int32)
    return ((jq, jkp, jvp, jnp.asarray(pt), jnp.asarray(kl)),
            (tq, tkp, tvp, torch.from_numpy(pt), torch.from_numpy(kl)))


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_reference(case, dtype):
    jargs, targs = _paged_pairs(case, dtype)
    window = case[3]
    port = paged_attention_ref(*targs, window=window)
    assert port.dtype == targs[0].dtype
    _close(port, jpaged_ref(*jargs, window=window), LM_TOL[dtype])


def test_paged_plain_matches_pallas_interpret():
    case = PAGED_CASES[1]
    jargs, targs = _paged_pairs(case)
    kw = dict(window=case[3], softcap=25.0)
    _close(paged_attention_ref(*targs, **kw),
           jpaged(*jargs, interpret=True, **kw), LM_TOL["float32"])


def test_paged_unmapped_page_below_kv_len_follows_reference():
    """Sequence 0 has an unmapped page (-1) below its kv_len. The port's
    plain version equals the reference's ``ref.py``, which gathers zeros
    there and gives them softmax weight; the reference's Pallas kernel
    skips the page and differs (ROADMAP Queue 3)."""
    pt = [[3, -1, 11, -1, -1], [0, 1, 2, 4, 5], [20, 21, -1, -1, -1]]
    jargs, targs = _paged_pairs(PAGED_CASES[0], pt=pt)
    ref = np.asarray(jpaged_ref(*jargs))
    _close(paged_attention_ref(*targs), ref, LM_TOL["float32"])
    ker = np.asarray(jpaged(*jargs, interpret=True))
    np.testing.assert_allclose(ker[1:], ref[1:], rtol=2e-5, atol=2e-5)
    assert np.abs(ker[0] - ref[0]).max() > 0.1


def test_paged_kv_len_zero_follows_reference():
    """Sequence 1 has kv_len = 0. The port's plain version equals the
    reference's ``ref.py``: a uniform average of the gathered rows. The
    reference's Pallas kernel returns 0 there and differs (ROADMAP
    Queue 3)."""
    case = PAGED_CASES[0]
    jargs, targs = _paged_pairs(case, kv_len=[2 * case[2] + 3, 0,
                                              case[2] + 1])
    ref = np.asarray(jpaged_ref(*jargs))
    _close(paged_attention_ref(*targs), ref, LM_TOL["float32"])
    ker = np.asarray(jpaged(*jargs, interpret=True))
    assert not ker[1].any() and np.abs(ref[1]).max() > 0.1
    np.testing.assert_allclose(ker[0::2], ref[0::2], rtol=2e-5, atol=2e-5)


def test_decode_attention_sink_len_matches_reference():
    rng = np.random.RandomState(8)
    B, S, Hq, Hkv, D = 3, 48, 6, 2, 16
    (jq, jk, jv), (q, k, v) = _pairs(
        [rng.randn(B, Hq, D), rng.randn(B, S, Hkv, D),
         rng.randn(B, S, Hkv, D)])
    kl = np.array([48, 20, 7], np.int32)
    kw = dict(window=9, attn_cap=15.0, sink_len=3)
    ref = jcommon.decode_attention(jq, jk, jv, jnp.asarray(kl), **kw)
    _close(common.decode_attention(q, k, v, torch.from_numpy(kl), **kw), ref,
           LM_TOL["float32"])


def test_gather_kv_matches_reference():
    """Unmapped pages read zeros; a page id past the pool reads the last
    page, as JAX's clamping gather does. Exact."""
    rng = np.random.RandomState(9)
    P, ps, Hkv, D = 6, 4, 2, 8
    (jk, jv), (k, v) = _pairs([rng.randn(P, ps, Hkv, D),
                               rng.randn(P, ps, Hkv, D)])
    pt = np.array([[2, -1, 9, 0], [5, 4, -1, -1], [1, 1, 3, 2]], np.int32)
    kl = np.array([16, 7, 12], np.int32)
    seq = np.array([2, 0], np.int32)
    jt = jkvc.SeqTable(jnp.asarray(pt), jnp.asarray(kl), jnp.ones(3, bool))
    tt = kvcache.SeqTable(torch.from_numpy(pt), torch.from_numpy(kl),
                          torch.ones(3, dtype=torch.bool))
    ref = jkvc.gather_kv(jkvc.PageData(jk, jv), jt, jnp.asarray(seq), 12)
    port = kvcache.gather_kv(kvcache.PageData(k, v), tt,
                             torch.from_numpy(seq), 12)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(tensor_to_numpy(b), np.asarray(a))


# --------------------------------------------------------------- gmm -------
@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_plain_matches_reference(case, dtype):
    E, C, D, F, act = case
    jargs, targs = _pairs(moe_inputs(E, C, D, F), dtype)
    port = moe_gmm_ref(*targs, activation=act)
    assert port.dtype == targs[0].dtype
    _close(port, jmoe_ref(*jargs, activation=act), LM_TOL[dtype], act)


def test_moe_plain_matches_pallas_interpret():
    E, C, D, F, act = MOE_CASES[1]
    jargs, targs = _pairs(moe_inputs(E, C, D, F))
    _close(moe_gmm_ref(*targs, activation=act),
           jmoe(*jargs, activation=act, bc=8, bf=16, interpret=True),
           LM_TOL["float32"])


# ------------------------------------------------------------- mamba -------
def _mamba_pairs(case, dtype="float32"):
    dt, x, Bm, Cm, A_log, D_skip = mamba_inputs(*case[:4])
    j, t = _pairs([dt, x, Bm, Cm], dtype)
    (ja, jd), (ta, td) = _pairs([A_log, D_skip])
    return j + [ja, jd], t + [ta, td]


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", MAMBA_CASES)
def test_mamba_plain_matches_reference(case, dtype):
    jargs, targs = _mamba_pairs(case, dtype)
    port = mamba_scan_ref(*targs)
    assert port.dtype == targs[1].dtype
    _close(port, jmamba_ref(*jargs), MAMBA_TOL[dtype])


def test_mamba_plain_matches_pallas_interpret():
    """The ragged case: the reference's wrapper pads S to its chunk."""
    case = MAMBA_CASES[2]
    jargs, targs = _mamba_pairs(case)
    _close(mamba_scan_ref(*targs),
           jmamba(*jargs, bd=case[4], chunk=case[5], interpret=True),
           MAMBA_TOL["float32"])


def test_linear_rnn_matches_reference():
    rng = np.random.RandomState(10)
    (ja, jb, jh), (a, b, h) = _pairs([rng.rand(2, 37, 3, 4),
                                      rng.randn(2, 37, 3, 4),
                                      rng.randn(2, 3, 4)])
    ref_out, ref_last = jrecurrent.linear_rnn(ja, jb, jh, chunk=16)
    out, last = recurrent.linear_rnn(a, b, h)
    _close(out, ref_out, 1e-6)
    _close(last, ref_last, 1e-6)


# ------------------------------------------------------------- glue --------
def test_tensor_conversion_keeps_bfloat16_bits():
    rng = np.random.RandomState(11)
    j = np.asarray(jnp.asarray(rng.randn(5, 7), jnp.bfloat16))
    t = tensor_from_numpy(j)
    assert t.dtype == torch.bfloat16 and t.shape == (5, 7)
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(), j.view(np.int16))
    np.testing.assert_array_equal(tensor_to_numpy(t), j.astype(np.float32))
    f = rng.randn(3, 2).astype(np.float32)
    np.testing.assert_array_equal(tensor_to_numpy(tensor_from_numpy(f)), f)


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors each wrapper is its plain version and launches
    nothing."""
    counts = [w.launches for w in (flash_ops.flash_attention,
                                   paged_ops.paged_attention,
                                   moe_ops.moe_gmm, mamba_ops.mamba_scan)]
    B, Sq, Sk, Hq, Hkv, D, causal, window, softcap = FLASH_CASES[2]
    _, (q, k, v) = _pairs(flash_inputs(B, Sq, Sk, Hq, Hkv, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    assert torch.equal(flash_ops.flash_attention(q, k, v, bq=32, bk=32, **kw),
                       flash_attention_ref(q, k, v, **kw))
    _, targs = _paged_pairs(PAGED_CASES[1])
    assert torch.equal(paged_ops.paged_attention(*targs, window=9),
                       paged_attention_ref(*targs, window=9))
    _, targs = _pairs(moe_inputs(*MOE_CASES[2][:4]))
    assert torch.equal(moe_ops.moe_gmm(*targs, activation="sq_relu"),
                       moe_gmm_ref(*targs, activation="sq_relu"))
    _, targs = _mamba_pairs(MAMBA_CASES[2])
    assert torch.equal(mamba_ops.mamba_scan(*targs, bd=8, chunk=8),
                       mamba_scan_ref(*targs))
    assert counts == [w.launches for w in (flash_ops.flash_attention,
                                           paged_ops.paged_attention,
                                           moe_ops.moe_gmm,
                                           mamba_ops.mamba_scan)]
