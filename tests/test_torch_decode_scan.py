"""The algorithms of the CUDA paged decode attention and selective scan
kernels, modelled in plain PyTorch on the CPU, and the Python arithmetic of
their launches.

``partition_model`` computes paged decode attention as
``csrc/paged_attention.cu`` does: each sequence cut into partitions of
``part`` pages, each partition's online-softmax state (m, l, acc) over its
visible keys alone (keys of unmapped pages and keys outside the window
weigh exactly 0, a partition with none keeps m = -1e30, l = 0, acc = 0),
and the partials of the live partitions merged as the kernel's second
launch merges them. It is held against the reference's Pallas kernel in
interpret mode, the semantics the CUDA kernel follows, on inputs where
that kernel and the reference's ``ref.py`` differ too.

``scan_model`` computes the selective scan as ``csrc/mamba_scan.cu`` does:
``a = 2^(dt·A₂)`` with log2(e) folded into ``A₂ = -exp(A_log)·log2(e)``,
and dt·x in float32, and the last state the kernel writes on request. It
is held against the reference's ``mamba_scan_ref`` and, for the state,
the last state of the reference's ``linear_rnn`` over the same
discretisation and the port's ``mamba_scan_ref(return_state=True)``.

The inputs are made from seeds with numpy (``test_torch_gpu.py``'s case
functions, whose card tests hold the kernels themselves).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import mamba_scan_ref as jmamba_ref
from repro.models.recurrent import linear_rnn as jlinear_rnn
from repro.kernels.paged_attention.ops import paged_attention as jpaged
from repro.kernels.paged_attention.ref import paged_attention_ref as \
    jpaged_ref

from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.tolerance import LM_TOL, MAMBA_TOL
from repro_torch.models.recurrent import linear_rnn

from test_torch_gpu import (LM_DTYPES, MAMBA_CASES, MAMBA_EDGE_CASES,
                            PAGED_CASES, mamba_inputs, paged_inputs,
                            paged_partition_case)

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _pairs(arrays, dtype="float32"):
    """Each array in ``dtype`` as a JAX array and as a port tensor, the
    same bits in both."""
    js = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    return js, [tensor_from_numpy(np.asarray(j)) for j in js]


def _close(port, ref, tol, what=""):
    np.testing.assert_allclose(tensor_to_numpy(port),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


# ------------------------------------------------------------- paged -------
def partition_model(q, k_pool, v_pool, page_table, kv_len, *, part,
                    window=None, softcap=None, scale=None):
    """Paged decode attention by partitions of ``part`` pages and their
    merge, in float32. Returns [B, Hq, D] in q's dtype."""
    B, Hq, D = q.shape
    P, ps, Hkv, _ = k_pool.shape
    g, n_pages = Hq // Hkv, page_table.shape[1]
    scale = D ** -0.5 if scale is None else scale
    k_rows = k_pool.float().reshape(P * ps, Hkv, D)
    v_rows = v_pool.float().reshape(P * ps, Hkv, D)
    p_lo, p_hi = paged_ops.live_partitions(kv_len, n_pages, ps, part,
                                           window)
    out = torch.zeros(B, Hq, D)
    for b in range(B):
        qb = q[b].float().reshape(Hkv, g, D) * scale
        kvl = int(kv_len[b])
        parts = []
        for p in range(int(p_lo[b]), int(p_hi[b])):
            pos = torch.arange(p * part * ps,
                               min((p + 1) * part * ps, n_pages * ps))
            page = page_table[b, pos // ps].long()
            vis = (pos < kvl) & (page >= 0)
            if window is not None:
                vis &= (kvl - 1) - pos < window
            rows = page.clamp(0, P - 1) * ps + pos % ps
            s = torch.einsum("hgd,thd->hgt", qb, k_rows[rows])
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            s = torch.where(vis, s, torch.tensor(NEG_INF))
            m = s.amax(-1)
            pr = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
            parts.append((m, pr.sum(-1),
                          torch.einsum("hgt,thd->hgd", pr, v_rows[rows])))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lt = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        at = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
        out[b] = (at / lt.clamp(min=1e-30)[..., None]).reshape(Hq, D)
    return out.to(q.dtype)


def _paged(args, dtype="float32"):
    """JAX and port versions of ``(q, k_pool, v_pool, page_table,
    kv_len)`` (numpy), the floats in ``dtype``."""
    q, kp, vp, pt, kl = args
    (jq, jkp, jvp), (tq, tkp, tvp) = _pairs([q, kp, vp], dtype)
    pt, kl = np.asarray(pt, np.int32), np.asarray(kl, np.int32)
    return ((jq, jkp, jvp, jnp.asarray(pt), jnp.asarray(kl)),
            (tq, tkp, tvp, torch.from_numpy(pt), torch.from_numpy(kl)))


# 1 and 2 pages a partition, and more than the table's 5 pages
PARTS = [1, 2, 7]


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("case", PAGED_CASES)
def test_partition_model_matches_pallas_interpret(case, part):
    Hq, Hkv, ps, window = case
    jargs, targs = _paged(paged_inputs(Hq, Hkv, ps))
    for softcap in (None, 25.0):
        kw = dict(window=window, softcap=softcap)
        _close(partition_model(*targs, part=part, **kw),
               jpaged(*jargs, interpret=True, **kw), LM_TOL["float32"],
               f"softcap={softcap}")


@pytest.mark.parametrize("part", PARTS)
def test_partition_model_follows_pallas_where_ref_differs(part):
    """An unmapped page below kv_len (sequence 0) is skipped, and kv_len =
    0 (sequence 1) gives exactly 0, as in the Pallas kernel; ``ref.py``
    differs on both, as ``test_torch_lm_kernels.py`` pins."""
    q, kp, vp, _, _ = paged_inputs(4, 2, 8)
    pt = [[3, -1, 11, -1, -1], [0, 1, 2, 4, 5], [20, 21, -1, -1, -1]]
    jargs, targs = _paged((q, kp, vp, pt, [2 * 8 + 3, 0, 8 + 1]))
    model = partition_model(*targs, part=part)
    ker = np.asarray(jpaged(*jargs, interpret=True))
    _close(model, ker, LM_TOL["float32"])
    assert not model[1].any()
    assert np.abs(ker[0] - np.asarray(jpaged_ref(*jargs))[0]).max() > 0.1


@pytest.mark.parametrize("part", [1, 2, 3])
def test_partition_model_unmapped_partition_and_window(part):
    """The card tests' long-sequence table at 4 tokens a page with
    page 5 unmapped (mid-partition at part = 2) and sequence 3's pages 2
    and 3 unmapped (all of partition 1 at part = 2), with and without
    window 21 (sequence 0's window starts mid-page and mid-partition) and
    softcap 25: the model equals the Pallas kernel, and the Pallas kernel
    equals ``ref.py`` on the table with those pages dropped, which is what
    the card test holds the CUDA kernel to."""
    q, kp, vp, pt, kl = paged_partition_case(2, 4)
    jargs, targs = _paged((q, kp, vp, pt, kl))
    for kw in (dict(), dict(window=21, softcap=25.0)):
        _close(partition_model(*targs, part=part, **kw),
               jpaged(*jargs, interpret=True, **kw), LM_TOL["float32"],
               f"all mapped {kw}")
    dropped, kl_dropped = pt.copy(), kl.copy()
    pt[0, 5] = -1
    dropped[0] = np.concatenate([pt[0, :5], pt[0, 6:], [-1]])
    kl_dropped[0] -= 4
    pt[3, 2:4] = -1
    dropped[3, 2:] = -1
    kl_dropped[3] = 8
    jargs, targs = _paged((q, kp, vp, pt, kl))
    ker = np.asarray(jpaged(*jargs, interpret=True))
    _close(partition_model(*targs, part=part), ker, LM_TOL["float32"],
           "unmapped")
    jdrop, _ = _paged((q, kp, vp, dropped, kl_dropped))
    np.testing.assert_allclose(ker, np.asarray(jpaged_ref(*jdrop)),
                               rtol=LM_TOL["float32"],
                               atol=LM_TOL["float32"])


def test_partition_model_in_bfloat16_inputs():
    """bf16 pools and queries (the values, widened): the model in float32
    against the Pallas kernel on the same bf16 inputs."""
    Hq, Hkv, ps, window = PAGED_CASES[1]
    jargs, targs = _paged(paged_inputs(Hq, Hkv, ps), "bfloat16")
    model = partition_model(*(t.float() if t.is_floating_point() else t
                              for t in targs), part=2, window=window)
    ker = jpaged(*(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a
                   for a in jargs), interpret=True, window=window)
    _close(model, ker, LM_TOL["float32"])


def test_live_partitions():
    """Partitions of 32 pages of 16 tokens (512 tokens, the default at
    ps = 16) over a 2,048-page table: kv_len 0 has none, 1 one, 32,768 all
    64, and a window of 4,096 at kv_len 10,000 the 9 from token 5,904 to
    9,999."""
    kl = torch.tensor([0, 1, 512, 513, 32768, 10_000], dtype=torch.int32)
    lo, hi = paged_ops.live_partitions(kl, 2048, 16, 32)
    assert lo.tolist() == [0, 0, 0, 0, 0, 0]
    assert hi.tolist() == [0, 1, 1, 2, 64, 20]
    lo, hi = paged_ops.live_partitions(kl, 2048, 16, 32, window=4096)
    assert (hi - lo).tolist() == [0, 1, 1, 2, 8, 9]
    assert lo[-1] == 5904 // 512 and hi[-1] == -(-10_000 // 512)
    # a table narrower than kv_len clips it
    lo, hi = paged_ops.live_partitions(kl, 3, 16, 2)
    assert hi.tolist() == [0, 1, 2, 2, 2, 2]


def test_paged_launch_arithmetic():
    """The default partition is 512 tokens; gemma2-27b decode_32k (B 32,
    Hq 32, Hkv 16, D 128, 2,048 pages of 16) gives 64 partitions, 32,768
    blocks and 33.8 MB of partials; the bench point (16 pages) one
    partition a sequence, no scratch, and 128 blocks."""
    assert paged_ops.default_part(16) == 32
    assert paged_ops.default_part(8) == 64
    assert paged_ops.default_part(1) == paged_ops.MAX_PART
    assert paged_ops.default_part(4096) == 1
    assert paged_ops.partitions(2048, 32) == 64
    assert paged_ops.partitions(2049, 32) == 65
    assert paged_ops.partitions(0, 32) == 1
    assert paged_ops.blocks(32, 16, 2, 2048, 32) == 32 * 64 * 16
    assert paged_ops.blocks(3, 2, 12, 5, 2) == 3 * 3 * 2 * 2
    assert paged_ops.scratch_bytes(32, 32, 128, 64) == 4 * 32 * 32 * 64 * 130
    assert paged_ops.partitions(16, paged_ops.default_part(16)) == 1
    assert paged_ops.scratch_bytes(16, 8, 128, 1) == 0
    assert paged_ops.blocks(16, 8, 1, 16, 32) == 128


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("D", paged_ops.HEAD_DIMS)
def test_paged_shared_memory_fits(D, itemsize):
    """Every head dim, dtype and group size, at the largest partition:
    a block's shared memory fits the 227 KB one block can have, its warps'
    rings three stages each; bf16 at D = 128 (gemma2) takes two warps and
    four blocks an SM (228 KB an SM, 1 KB of it reserved a block)."""
    warps, stages, stage = paged_ops.ring(D, itemsize)
    assert 1 <= warps <= 4 and stages == 3
    assert stage == 2 * paged_ops.TILE_KEYS * (D * itemsize + 16)
    for g in (1, 2, 3, 4, 5, 8, 12, 16):
        smem = paged_ops.smem_bytes(D, g, itemsize, paged_ops.MAX_PART)
        assert smem <= _cuda.MAX_SMEM
        # the warps' merge reuses the rings
        assert warps * paged_ops.group_size(g) * (D + 2) * 4 \
            <= warps * stages * stage
    if (D, itemsize) == (128, 2):
        assert (warps, stages) == (2, 3)
        assert 4 * (paged_ops.smem_bytes(D, 2, 2, 32) + 1024) <= 233_472


# ------------------------------------------------------------- mamba -------
def scan_model(dt, x, Bm, Cm, A_log, D_skip):
    """The scan as the kernel computes it: a = 2^(dt·A₂) with
    A₂ = -exp(A_log)·log2(e), b = (dt·x)·B with dt·x in float32. Returns
    y and the float32 state after the last step, h_last [B, Di, N]."""
    B, S, Di = x.shape
    A2 = -torch.exp(A_log.float()) * LOG2E
    a = torch.exp2(dt.float()[..., None] * A2[None, None])
    b = (dt.float() * x.float())[..., None] * Bm.float()[:, :, None, :]
    hs, h_last = linear_rnn(a, b, torch.zeros(B, Di, A2.shape[1]))
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm.float())
    return (y + D_skip[None, None] * x.float()).to(x.dtype), h_last


def jlast_state(dt, x, Bm, A_log):
    """The reference's last state: its ``linear_rnn`` over
    ``mamba_scan_ref``'s discretisation, from zero."""
    A = -jnp.exp(A_log.astype(jnp.float32))
    a = jnp.exp(dt.astype(jnp.float32)[..., None] * A[None, None])
    b = (dt * x).astype(jnp.float32)[..., None] \
        * Bm.astype(jnp.float32)[:, :, None, :]
    h0 = jnp.zeros((x.shape[0], x.shape[2], A.shape[1]), jnp.float32)
    return jlinear_rnn(a, b, h0, chunk=16)[1]


def _mamba(case, dtype):
    dt, x, Bm, Cm, A_log, D_skip = mamba_inputs(*case[:4])
    js, ts = _pairs([dt, x, Bm, Cm], dtype)
    (ja, jd), (ta, td) = _pairs([A_log, D_skip])
    return js + [ja, jd], ts + [ta, td]


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", MAMBA_CASES + MAMBA_EDGE_CASES)
def test_scan_model_matches_reference(case, dtype):
    jargs, targs = _mamba(case, dtype)
    out, _ = scan_model(*targs)
    assert out.dtype == targs[1].dtype
    _close(out, jmamba_ref(*jargs), MAMBA_TOL[dtype])


@pytest.mark.parametrize("dtype", LM_DTYPES)
@pytest.mark.parametrize("case", MAMBA_CASES + MAMBA_EDGE_CASES)
def test_scan_model_last_state_matches_reference(case, dtype):
    """The state the kernel writes (its exp2 discretisation, dt·x in
    float32 where the reference rounds it to the inputs' dtype: hence the
    dtype's tolerance) against the reference's ``linear_rnn`` last state;
    the port's plain version with ``return_state``, which rounds as the
    reference does, within float32's; its y is its default call's."""
    jargs, targs = _mamba(case, dtype)
    _, h_last = scan_model(*targs)
    want = jlast_state(*jargs[:3], jargs[4])
    assert h_last.dtype == torch.float32
    _close(h_last, want, MAMBA_TOL[dtype], "h_last against the reference")
    y, h_ref = mamba_scan_ref(*targs, return_state=True)
    assert torch.equal(y, mamba_scan_ref(*targs))
    _close(h_ref, want, MAMBA_TOL["float32"], "mamba_scan_ref h_last")


@pytest.mark.parametrize("dtype", LM_DTYPES)
def test_scan_ref_from_a_state_matches_reference(dtype):
    """``mamba_scan_ref(h0=...)``, the mamba layer's plain scan from a
    decode cache's state, against the reference's ``linear_rnn`` from the
    same state over ``mamba_scan_ref``'s discretisation: y and the last
    state."""
    jargs, targs = _mamba((2, 37, 12, 5), dtype)
    jdt, jx, jB, jC, jA_log, jD = jargs
    h0 = np.random.default_rng(7).standard_normal((2, 12, 5)).astype(
        np.float32)
    A = -jnp.exp(jA_log.astype(jnp.float32))
    a = jnp.exp(jdt.astype(jnp.float32)[..., None] * A[None, None])
    b = (jdt * jx).astype(jnp.float32)[..., None] \
        * jB.astype(jnp.float32)[:, :, None, :]
    hs, want_h = jlinear_rnn(a, b, jnp.asarray(h0), chunk=16)
    want_y = (jnp.einsum("bsdn,bsn->bsd", hs, jC.astype(jnp.float32))
              + jD[None, None] * jx).astype(jx.dtype)
    y, h_last = mamba_scan_ref(*targs, h0=torch.from_numpy(h0),
                               return_state=True)
    assert y.dtype == targs[1].dtype and h_last.dtype == torch.float32
    _close(y, want_y, MAMBA_TOL[dtype], "y from a state")
    _close(h_last, want_h, MAMBA_TOL["float32"], "h_last from a state")


def test_scan_model_padded_states_and_steps():
    """The wrapper's padding: zero states beyond N (and A_log 0 there) and
    zero steps beyond S leave y over the real states and steps as it is."""
    dt, x, Bm, Cm, A_log, D_skip = (torch.from_numpy(a) for a in
                                    mamba_inputs(2, 37, 12, 5))
    pad = lambda t, n, s: torch.nn.functional.pad(t, (0, n, 0, s))  # noqa
    ref, h_ref = scan_model(dt, x, Bm, Cm, A_log, D_skip)
    out, h_last = scan_model(pad(dt, 0, 11), pad(x, 0, 11), pad(Bm, 3, 11),
                             pad(Cm, 3, 11),
                             torch.nn.functional.pad(A_log, (0, 3)), D_skip)
    np.testing.assert_array_equal(out[:, :37].numpy(), ref.numpy())
    # the last state after the padded steps is the state after step S
    np.testing.assert_array_equal(h_last[..., :5].numpy(), h_ref.numpy())
    assert not h_last[..., 5:].any()


def test_scan_launch_arithmetic():
    """State widths, channels a block and blocks: at jamba width (B 2, Di
    8,192) two lanes a channel give 256 blocks of 128 threads; B·Di = 8 is
    one block of one warp; a block's channels are whole 16-byte copies of
    a step and whole warps."""
    assert [mamba_ops.state_width(n) for n in (1, 8, 9, 16, 17, 33, 64)] \
        == [8, 8, 16, 16, 32, 64, 64]
    assert mamba_ops.launch_shape(2, 8192) == (256, 128)
    # the default launch there: 64 steps a stage, two blocks an SM
    assert mamba_ops.chunk_steps(64, 16, 64, 2) == 64
    assert 2 * (mamba_ops.smem_bytes(16, 64, 64, 2) + 1024) <= 233_472
    assert mamba_ops.launch_shape(2, 8192, 64) == (256, 128)
    assert mamba_ops.launch_shape(1, 8) == (1, 32)
    assert mamba_ops.launch_shape(1, 8, 8) == (1, 32)
    assert mamba_ops.launch_shape(2, 40, 32) == (4, 64)
    assert mamba_ops.launch_shape(2, 40, 16) == (6, 32)
    assert mamba_ops.launch_shape(2, 13) == (2, 32)
    assert mamba_ops.launch_shape(2, 24, 1000) == (2, 64)
    for item in (2, 4):
        for bd in (None, 1, 5, 48, 1000):
            c = mamba_ops.block_channels(bd, 8192, item)
            assert (c * mamba_ops.LANES) % 32 == 0 and (c * item) % 16 == 0
            assert c * mamba_ops.LANES <= mamba_ops.MAX_THREADS


@pytest.mark.parametrize("N, want", [(8, 19968), (16, 23552), (32, 30720),
                                     (64, 45056)])
def test_scan_staging_bytes(N, want):
    """A block's shared memory at the jamba launch (64 channels, two lanes
    each, 16 steps a stage, bf16): three stages of dt, x, B and C, two
    chunks of y, and two of B and C in float32, for each state count. A
    chunk is cut until the largest block (128 channels, float32, 64
    states) fits."""
    assert mamba_ops.smem_bytes(N, 16, 64, 2) == want
    assert mamba_ops.chunk_steps(16, N, 64, 2) == 16
    assert mamba_ops.chunk_steps(1000, N, 64, 2) == mamba_ops.MAX_CHUNK
    big = mamba_ops.chunk_steps(64, 64, 128, 4)
    assert mamba_ops.smem_bytes(64, big, 128, 4) <= _cuda.MAX_SMEM
    assert mamba_ops.smem_bytes(64, 2 * big, 128, 4) > _cuda.MAX_SMEM
