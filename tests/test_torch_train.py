"""The port's training stack against the reference's, on the CPU.

``make_batch`` given the reference's draws, ``async_commit`` and the int8
compression given the same noise are held bit for bit. The optimizer
(``schedule``, ``global_norm``, three ``apply`` steps) and the
microbatched train step (two steps) run in float32 from the reference's
parameters and are held within stated limits: the float32 sums of the two
packages run in other orders, so they differ in the last bits. The remat
policies are held bit for bit to no remat, a training checkpoint the port
writes is read by the reference's ``snapshot.restore``, and
``examples/train_lm_torch.py``'s failure and recovery is exact at a tiny
size.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import snapshot as jsnapshot
from repro.configs import get_arch as jget, reduced as jreduced
from repro.data import pipeline as jpipe
from repro.models import api as japi
from repro.train import async_commit as jac, compression as jcomp, \
    optimizer as jopt, trainstep as jts

from repro_torch import convert, policy
from repro_torch.configs import get_arch, reduced
from repro_torch.data import pipeline as pipe
from repro_torch.kernels import _cuda
from repro_torch.models import api
from repro_torch.train import async_commit as ac, checkpoint, \
    compression as comp, optimizer as opt, trainstep as ts

from test_torch_train_models import _rel_rms

ROOT = Path(__file__).resolve().parents[1]
# float32 limits, each beside the largest reading over the cases here
SCHED_RTOL = 2e-6    # the learning rate (read: 3.6e-7, a cosine's ulps)
OPT_RTOL = 1e-6      # params, m and v after 3 steps, of each leaf's
#                      largest value (read: 1.6e-7)
STEP_RTOL = 3e-5     # params after 2 train steps, relative RMS (read:
#                      6.7e-6)
LOSS_RTOL = 1e-6     # a train step's loss (read: 1.4e-7)
GNORM_RTOL = 5e-6    # a train step's gradient norm (read: 5.1e-7)


def _conv(a):
    return convert.tensor_from_numpy(np.asarray(a))


def _walk(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "name", None))] \
            if isinstance(tree, dict) else getattr(tree, k.name)
    return tree


def _leaves_with_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# ---------------------------------------------------------- make_batch ----
def _ref_draws(cfg, jarch, step, shard, n_shards):
    """The reference's draws of ``make_batch(cfg, step, shard)``."""
    b = cfg.global_batch // n_shards
    S1 = cfg.seq_len + 1
    key = jpipe._fold(jax.random.PRNGKey(cfg.seed), step, shard)
    k1, k2, k3 = jax.random.split(key, 3)
    d = {"motif": jax.random.randint(k1, (b, cfg.motif_len), 0, cfg.vocab),
         "noise_tok": jax.random.randint(k2, (b, S1), 0, cfg.vocab),
         "uniform": jax.random.uniform(k3, (b, S1))}
    for name, off, on, n in (("frames", 1, jarch.is_encdec,
                              jarch.encoder_seq),
                             ("patches", 2, jarch.is_prefix_lm,
                              jarch.prefix_len)):
        if on:
            k = jpipe._fold(jax.random.PRNGKey(cfg.seed + off), step, shard)
            d[name] = jax.random.normal(k, (b, n, jarch.d_model),
                                        jarch.param_dtype)
    return {k: _conv(v) for k, v in d.items()}


@pytest.mark.parametrize("aid", ["granite-3-8b", "whisper-medium",
                                 "paligemma-3b"])
@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (5, 1, 2)])
def test_make_batch_matches_reference_given_its_draws(aid, step, shard,
                                                      n_shards):
    jarch, arch = jreduced(jget(aid)), reduced(get_arch(aid))
    jcfg = jpipe.DataConfig(vocab=jarch.vocab, seq_len=24, global_batch=4,
                            noise=0.3)
    cfg = pipe.DataConfig(vocab=arch.vocab, seq_len=24, global_batch=4,
                          noise=0.3)
    ref = jpipe.make_batch(jcfg, step, shard, n_shards, arch=jarch)
    port = pipe.make_batch(cfg, step, shard, n_shards, arch=arch,
                           device="cpu",
                           draws=_ref_draws(jcfg, jarch, step, shard,
                                            n_shards))
    assert sorted(ref) == sorted(port)
    for k in ref:
        a = _conv(ref[k])
        assert a.dtype == port[k].dtype, k
        assert torch.equal(a, port[k]), k


def test_make_batch_is_deterministic_per_step_and_shard():
    arch = reduced(get_arch("paligemma-3b"))
    cfg = pipe.DataConfig(vocab=arch.vocab, seq_len=32, global_batch=4)
    a = pipe.make_batch(cfg, 7, 1, 2, arch=arch, device="cpu")
    b = pipe.make_batch(cfg, 7, 1, 2, arch=arch, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for other in (pipe.make_batch(cfg, 8, 1, 2, arch=arch, device="cpu"),
                  pipe.make_batch(cfg, 7, 0, 2, arch=arch, device="cpu")):
        assert not torch.equal(a["tokens"], other["tokens"])
        assert not torch.equal(a["patches"], other["patches"])
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])
    # the motif repeats where no noise token replaced it
    seq = torch.cat([a["tokens"], a["targets"][:, -1:]], 1)
    same = (seq[:, 16:] == seq[:, :-16]).float().mean()
    assert same > 0.7, same


# ----------------------------------------------------------- optimizer ----
def test_schedule_matches_reference():
    for cfg in (opt.AdamWConfig(), opt.AdamWConfig(lr=1e-3, warmup_steps=8,
                                                   total_steps=24)):
        jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
        steps = np.arange(0, cfg.total_steps + 40, 3, dtype=np.int32)
        ref = np.asarray(jax.vmap(lambda s: jopt.schedule(jcfg, s))(steps))
        port = opt.schedule(cfg, torch.from_numpy(steps)).numpy()
        assert port.dtype == np.float32
        np.testing.assert_allclose(port, ref, rtol=SCHED_RTOL)


def _granite(dtype="float32"):
    jcfg = jreduced(jget("granite-3-8b"), dtype=dtype)
    cfg = reduced(get_arch("granite-3-8b"), dtype=dtype)
    params = japi.build(jcfg).init(jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, cfg, model


def _assert_tree_close(ref, port_tree, rtol, what):
    for path, a in _leaves_with_paths(ref):
        b = _walk(port_tree, path)
        np.testing.assert_allclose(np.asarray(b), np.asarray(a, np.float32),
                                   rtol=rtol, atol=rtol * float(
                                       np.abs(np.asarray(a)).max()),
                                   err_msg=f"{what} {path}")


def test_global_norm_and_three_apply_steps_match_reference():
    jcfg, params, cfg, model = _granite()
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                           clip_norm=5.0)
    jocfg = jopt.AdamWConfig(**dataclasses.asdict(ocfg))
    rng = np.random.RandomState(1)
    jstate, state = jopt.init(params), opt.init(model)
    for i in range(3):
        # the third step's gradients are large, so clipping acts
        g = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape) * (
            0.05 if i < 2 else 2.0), jnp.float32), params)
        grads = {n: convert._leaf_tensor(jax.tree.map(np.asarray, g), n,
                                         cfg.unit_len)
                 for n, _ in model.named_parameters()}
        np.testing.assert_allclose(float(opt.global_norm(grads)),
                                   float(jopt.global_norm(g)), rtol=OPT_RTOL)
        params, jstate, jm = jopt.apply(jocfg, params, g, jstate)
        model, state, m = opt.apply(ocfg, model, grads, state)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=OPT_RTOL)
        assert int(state.step) == int(jstate.step) == i + 1
        _assert_tree_close(params, convert.lm_params_to_numpy(model),
                           OPT_RTOL, f"params after step {i + 1}")
        ost = convert.adamw_state_to_numpy(model, state)
        _assert_tree_close(jstate.m, ost.m, OPT_RTOL, "m")
        _assert_tree_close(jstate.v, ost.v, OPT_RTOL, "v")
    assert float(m["grad_norm"]) > ocfg.clip_norm


def test_apply_keeps_bf16_parameters_without_a_master_copy():
    _, _, cfg, model = _granite("bfloat16")
    state = opt.init(model)
    assert all(v.dtype == torch.float32 for v in state.m.values())
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model, state, _ = opt.apply(opt.AdamWConfig(warmup_steps=1), model,
                                grads, state)
    cfg1 = opt.AdamWConfig(warmup_steps=1)
    lr = opt.schedule(cfg1, torch.tensor(1, dtype=torch.int32))
    scale = torch.clamp(1.0 / opt.global_norm(grads), max=1.0)
    for n, p in model.named_parameters():
        assert p.dtype == before[n].dtype
        # the float32 update from the bf16 value, rounded once to bf16
        g = torch.ones(p.shape) * scale
        m, v = 0.1 * g, 0.05 * g * g
        delta = (m / 0.1) / (torch.sqrt(v / 0.05) + 1e-8) \
            + 0.1 * before[n].float()
        want = (before[n].float() - lr * delta).to(p.dtype)
        assert torch.equal(p.detach(), want), n
    assert opt.AdamWState._fields == ("step", "m", "v")


# --------------------------------------------------------- compression ----
def _grad_tree(rng, scale=1.0):
    return {"a": (rng.randn(5, 7) * scale).astype(np.float32),
            "b": {"c": (rng.randn(33) * 3 * scale).astype(np.float32)}}


def _uniforms(key, tree):
    """The reference's per-leaf uniform draws of ``compress_tree``."""
    leaves, _ = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(leaves))
    return [_conv(jax.random.uniform(k, np.shape(x)))
            for x, k in zip(leaves, keys)]


def _tree_equal(ref, port, what):
    for path, a in _leaves_with_paths(ref):
        b = _walk(port, path)
        assert torch.equal(_conv(a), b), f"{what} {path}"


def test_int8_compress_matches_reference():
    rng = np.random.RandomState(0)
    for x in (rng.randn(64, 3).astype(np.float32) * 1e-3,
              np.zeros((4,), np.float32),
              np.array([127.0, -127.0, 0.5, -0.5, 1.49], np.float32)):
        key = jax.random.PRNGKey(3)
        q, s = jcomp.int8_compress(jnp.asarray(x), key)
        u = _conv(jax.random.uniform(key, x.shape))
        tq, ts_ = comp.int8_compress(torch.from_numpy(x), u)
        assert tq.dtype == torch.int8
        assert torch.equal(tq, _conv(q)) and torch.equal(ts_, _conv(s))
        assert torch.equal(comp.int8_decompress(tq, ts_),
                           _conv(jcomp.int8_decompress(q, s)))


def test_compress_tree_and_ef_apply_match_reference():
    rng = np.random.RandomState(1)
    g = _grad_tree(rng)
    key = jax.random.PRNGKey(5)
    qs, scales = jcomp.compress_tree(g, key)
    tg = jax.tree.map(_conv, g)
    tqs, tscales = comp.compress_tree(tg, _uniforms(key, g))
    _tree_equal(qs, tqs, "q")
    _tree_equal(scales, tscales, "scale")
    ef = jcomp.ef_init(g)
    tef = comp.ef_init(tg)
    for i in range(3):
        k = jax.random.PRNGKey(10 + i)
        g = _grad_tree(rng)
        qs, scales, ef = jcomp.ef_apply(g, ef, k)
        corrected = jax.tree.map(lambda a, r: a + r, g, ef.residual)
        tqs, tscales, tef = comp.ef_apply(jax.tree.map(_conv, g), tef,
                                          _uniforms(k, corrected))
        _tree_equal(qs, tqs, f"ef q {i}")
        _tree_equal(scales, tscales, f"ef scale {i}")
        _tree_equal(ef.residual, tef.residual, f"residual {i}")


@pytest.mark.parametrize("mixed", [False, True], ids=["equal", "mixed"])
@pytest.mark.parametrize("with_ef", [False, True], ids=["plain", "ef"])
def test_pod_allreduce_compressed_matches_reference(mixed, with_ef):
    """Over 3 pods: the reference's ``psum``/``pmax`` under ``jax.vmap``
    with a named axis, the port's over the leading pod axis. ``mixed``
    scales the pods' gradients by 1, 4 and 0.25: the result then is
    the reference's sum of codes under the largest scale, not the
    mean."""
    n = 3
    rng = np.random.RandomState(2)
    pods = [_grad_tree(rng, scale=(1.0, 4.0, 0.25)[i] if mixed else 1.0)
            for i in range(n)]
    if not mixed:    # equal scales: each pod's largest |x| is the same
        for p in pods:
            p["a"][0, 0] = 10.0
            p["b"]["c"][0] = 10.0
    stacked = jax.tree.map(lambda *x: np.stack(x), *pods)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    jef = jcomp.ef_init(stacked) if with_ef else None

    def one(g, k, res):
        ef = jcomp.EFState(res) if with_ef else None
        out, ef = jcomp.pod_allreduce_compressed(g, "pod", k, ef)
        return out, (ef.residual if with_ef else 0)
    out, res = jax.vmap(one, axis_name="pod")(
        stacked, keys, jef.residual if with_ef else jnp.zeros(n))
    noise = []
    for i in range(n):
        tree = pods[i] if not with_ef else jax.tree.map(
            lambda x: x.astype(np.float32), pods[i])
        noise.append(_uniforms(keys[i], tree))
    tef = comp.ef_init(jax.tree.map(_conv, stacked)) if with_ef else None
    tout, tef = comp.pod_allreduce_compressed(
        jax.tree.map(_conv, stacked), noise, tef)
    for path, a in _leaves_with_paths(out):
        a = np.asarray(a)
        assert all(np.array_equal(a[0], a[i]) for i in range(n))
        assert torch.equal(_conv(a[0]), _walk(tout, path)), path
    if with_ef:
        _tree_equal(res, tef.residual, "residual")
    # the arithmetic: sum of codes × the largest scale / n
    qs = [comp.compress_tree(jax.tree.map(_conv, p), u)
          for p, u in zip(pods, noise)] if not with_ef else None
    if qs is not None:
        q_a = sum(q["a"].to(torch.int32) for q, _ in qs)
        s_a = max(float(s["a"]) for _, s in qs)
        assert torch.equal(tout["a"], q_a.float() * torch.tensor(s_a) / n)
        mean = torch.from_numpy(np.mean([p["a"] for p in pods], 0))
        err = float((tout["a"] - mean).abs().max())
        step = min(float(s["a"]) for _, s in qs)
        # equal scales: within a code step of the mean; mixed: far off
        assert (err > 10 * step) == mixed, (err, step)


# -------------------------------------------------------- async_commit ----
def test_async_commit_matches_reference():
    rng = np.random.RandomState(3)
    params = {"w": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    tparams = jax.tree.map(_conv, params)
    js, ts_ = jac.init(4, params), ac.init(4, tparams)
    order = [0, 2, 2, 3, 0, 2, 1]
    for i, grp in enumerate(order):
        upd = jax.tree.map(lambda p: (rng.randn(*p.shape) * (i + 1))
                           .astype(np.float32), params)
        js = jac.commit(js, grp, upd)
        ts_ = ac.commit(ts_, grp, jax.tree.map(_conv, upd))
    assert torch.equal(ts_.vec, _conv(np.asarray(js.vec).view(np.int32)))
    _tree_equal(js.deltas, ts_.deltas, "deltas")
    for my in (3, np.uint32(2), np.uint32(0xFFFFFFFF)):
        assert torch.equal(ac.read_frontier(ts_, my),
                           _conv(jac.read_frontier(js, jnp.uint32(my))))
        for bound in (0, 1, 2):
            assert bool(ac.can_proceed(ts_, my, bound)) == bool(
                jac.can_proceed(js, jnp.uint32(my), bound))
            assert torch.equal(ac.straggler_mask(ts_, my, bound), _conv(
                jac.straggler_mask(js, jnp.uint32(my), bound)))
    for w in (None, np.array([0.5, 0.1, 0.3, 0.1], np.float32)):
        ref = jac.snapshot_combine(js, params, None if w is None
                                   else jnp.asarray(w))
        port = ac.snapshot_combine(ts_, tparams, None if w is None
                                   else torch.from_numpy(w))
        _tree_equal(ref, port, f"snapshot_combine {w}")


def test_commit_counter_wraps_as_uint32():
    st = ac.init(2, {"w": torch.zeros(2)})
    st = st._replace(vec=torch.tensor([-1, 5], dtype=torch.int32))
    st = ac.commit(st, 0, {"w": torch.ones(2)})
    js = jac.CommitVectorState(vec=jnp.asarray([0xFFFFFFFF, 5], jnp.uint32),
                               deltas={"w": jnp.zeros((2, 2))})
    js = jac.commit(js, 0, {"w": jnp.ones(2)})
    assert torch.equal(st.vec, _conv(np.asarray(js.vec).view(np.int32)))
    assert torch.equal(ac.read_frontier(st, 3),
                       _conv(jac.read_frontier(js, jnp.uint32(3))))


# ---------------------------------------------------------- train step ----
def _batch(jcfg, cfg, B=4, S=16, seed=0):
    jd = jpipe.DataConfig(vocab=jcfg.vocab, seq_len=S, global_batch=B)
    jb = jpipe.make_batch(jd, seed, arch=jcfg)
    return jb, {k: _conv(v) for k, v in jb.items()}


@pytest.mark.parametrize("aid", ["granite-3-8b", "granite-moe-1b-a400m"])
def test_train_step_with_microbatches_matches_reference(aid):
    jcfg = jreduced(jget(aid), dtype="float32")
    cfg = reduced(get_arch(aid), dtype="float32")
    jm, m = japi.build(jcfg), api.build(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), "cpu")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    jstep = jax.jit(jts.make_train_step(
        jm, jopt.AdamWConfig(**dataclasses.asdict(ocfg)), n_microbatches=2))
    step = ts.make_train_step(m, ocfg, n_microbatches=2, device="cpu")
    jstate, state = jopt.init(params), opt.init(model)
    for i in range(2):
        jb, tb = _batch(jcfg, cfg, seed=i)
        params, jstate, jmet = jstep(params, jstate, jb)
        model, state, met = step(model, state, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol={"loss": LOSS_RTOL,
                                             "grad_norm": GNORM_RTOL,
                                             "lr": 0}[k], err_msg=k)
        port = convert.lm_params_to_numpy(model)
        for path, a in _leaves_with_paths(params):
            r = _rel_rms(a, _walk(port, path))
            assert r <= STEP_RTOL, (i, path, r)


def test_microbatches_sum_gradients_in_float32():
    """Two microbatches' float32 sums, halved, are the mean of their
    gradients: the gradient the optimizer sees equals the two
    microbatches' autograd gradients summed in float32."""
    _, _, cfg, model = _granite()
    m = api.build(cfg)
    _, tb = _batch(jreduced(jget("granite-3-8b")), cfg)
    seen = {}
    real_apply = opt.apply

    def spy(ocfg, params, grads, state):
        seen.update({n: g.clone() for n, g in grads.items()})
        return real_apply(ocfg, params, grads, state)
    halves = ts.split_microbatches(tb, 2)
    names, ps = zip(*model.named_parameters())
    want = [torch.zeros(p.shape) for p in ps]
    for mb in halves:
        gs = torch.autograd.grad(m.train_loss(model, mb), ps)
        for a, g in zip(want, gs):
            a += g
    opt.apply = spy
    try:
        ts.make_train_step(m, opt.AdamWConfig(), 2, device="cpu")(
            model, opt.init(model), tb)
    finally:
        opt.apply = real_apply
    for n, w in zip(names, want):
        assert torch.equal(seen[n], w / 2), n


def _one_step(policy_name=None, remat=None, n_micro=1):
    _, _, cfg, model = _granite()
    _, tb = _batch(jreduced(jget("granite-3-8b")), cfg)
    prev = policy.current()
    if policy_name:
        policy.set_policy(policy_name)
    try:
        step = ts.make_train_step(api.build(cfg), opt.AdamWConfig(),
                                  n_micro, remat_policy=remat, device="cpu")
        model, state, met = step(model, opt.init(model), tb)
    finally:
        policy.set_policy(prev)
    return model, state, met


@pytest.mark.parametrize("remat,policy_name", [
    ("nothing_saveable", None), ("dots_saveable", None),
    ("dots_with_no_batch_dims", None), ("nothing_saveable", "opt"),
    ("nothing_saveable", "opt-remat-unit")])
def test_remat_policies_are_bit_identical_to_no_remat(remat, policy_name):
    """Against the same step with no checkpoint at all (the loss called
    directly): every parameter, moment and metric bit for bit. ``opt``
    turns on ``remat_unit`` with ``remat_save_block_out`` (and one
    microbatch), ``opt-remat-unit`` ``remat_unit`` alone."""
    real = ts.remat
    ts.remat = lambda fn, policy: fn
    try:
        base = _one_step()          # the baseline policy: no remat_unit
    finally:
        ts.remat = real
    other = _one_step(policy_name, remat)
    for (n, a), (_, b) in zip(base[0].named_parameters(),
                              other[0].named_parameters()):
        assert torch.equal(a, b), n
    for n in base[1].m:
        assert torch.equal(base[1].m[n], other[1].m[n]), n
        assert torch.equal(base[1].v[n], other[1].v[n]), n
    for k in base[2]:
        assert torch.equal(base[2][k], other[2][k]), k


def test_policy_defaults_reach_the_train_step(monkeypatch):
    """``remat_policy`` and ``n_microbatches`` come from the active
    PerfPolicy, as the reference's do."""
    seen = {}
    real_remat, real_split = ts.remat, ts.split_microbatches

    def remat(fn, pol):
        seen["remat"] = pol
        return real_remat(fn, pol)

    def split(batch, n):
        seen["n"] = n
        return real_split(batch, n)
    monkeypatch.setattr(ts, "remat", remat)
    monkeypatch.setattr(ts, "split_microbatches", split)
    prev = policy.current()
    policy.set_policy(policy.PerfPolicy(name="t", n_microbatches=4,
                                        remat="dots_saveable"))
    try:
        _, _, cfg, model = _granite()
        step = ts.make_train_step(api.build(cfg), opt.AdamWConfig(), 1,
                                  device="cpu")
        _, tb = _batch(jreduced(jget("granite-3-8b")), cfg, B=4)
        step(model, opt.init(model), tb)
    finally:
        policy.set_policy(prev)
    assert seen == {"remat": "dots_saveable", "n": 4}
    with pytest.raises(KeyError, match="remat"):
        ts.make_train_step(api.build(cfg), opt.AdamWConfig(),
                           remat_policy="everything", device="cpu")


def test_policy_copy_matches_reference():
    from repro import policy as jpolicy
    assert sorted(policy.POLICIES) == sorted(jpolicy.POLICIES)
    for name, p in policy.POLICIES.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(
            jpolicy.POLICIES[name]), name
    assert policy.current().name == "baseline"


def test_kernel_wrappers_refuse_a_gradient():
    """``_cuda.refuse_grad``, which every LM kernel wrapper calls on CUDA
    inputs before it builds or launches anything."""
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient.*plain path"):
        _cuda.refuse_grad("flash_attention", "common.chunked_attention",
                          torch.ones(2), x)
    with torch.no_grad():
        _cuda.refuse_grad("flash_attention", "plain", x)
    _cuda.refuse_grad("flash_attention", "plain", x.detach())


# --------------------------------------------------------- checkpoints ----
def test_training_checkpoint_restores_into_the_reference_trees(tmp_path):
    jcfg, params, cfg, model = _granite("bfloat16")
    state = opt.init(model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            state.m[n].normal_()
            state.v[n].uniform_()
    state = state._replace(step=torch.tensor(7, dtype=torch.int32))
    checkpoint.save_async(str(tmp_path), model, state, step=7).join()
    jp, jo, meta = jsnapshot.restore(str(tmp_path), params,
                                     jopt.init(params))
    assert meta["step"] == 7 and int(jo.step) == 7
    ref_p = convert.lm_params_to_numpy(model)
    for path, a in _leaves_with_paths(jp):
        assert a.dtype == _walk(params, path).dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      _walk(ref_p, path), err_msg=str(path))
    ost = convert.adamw_state_to_numpy(model, state)
    for name in ("m", "v"):
        for path, a in _leaves_with_paths(getattr(jo, name)):
            np.testing.assert_array_equal(
                np.asarray(a), _walk(getattr(ost, name), path))
    # and back into the port
    fresh = api.build(cfg).init(torch.Generator().manual_seed(9),
                                device="cpu")
    fresh, st2, _ = checkpoint.restore(str(tmp_path), fresh,
                                       opt.init(fresh))
    for (n, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(state.m[n], st2.m[n]), n
    assert int(st2.step) == 7


def test_adamw_state_round_trips_through_convert():
    jcfg, params, cfg, model = _granite()
    js = jopt.init(params)
    js = js._replace(step=jnp.asarray(3, jnp.int32),
                     m=jax.tree.map(lambda x: x + 1.5, js.m))
    st = convert.adamw_state_from_numpy(model, jax.tree.map(np.asarray, js))
    assert int(st.step) == 3
    back = convert.adamw_state_to_numpy(model, st)
    for path, a in _leaves_with_paths(js.m):
        np.testing.assert_array_equal(np.asarray(a), _walk(back.m, path))


# -------------------------------------------------- fail and recover ----
def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fail_and_recover_is_bit_identical_on_the_cpu(monkeypatch):
    """``examples/train_lm_torch.py`` at a tiny preset: 10 steps, a
    checkpoint every 4, the failure after step 7 (a replay of steps 4-6);
    the recovered parameters equal the uninterrupted run's exactly, and
    so do the losses."""
    ex = _example()
    monkeypatch.setitem(ex.PRESETS, "tiny", dict(
        d_model=64, n_layers=2, d_ff=128, vocab=256, n_heads=4,
        n_kv_heads=2, seq=16, batch=4))
    lines = []
    diff, l_fail, l_ref = ex.run(10, 7, "tiny", 4, "cpu", lines.append)
    assert diff == 0.0
    assert l_fail == l_ref
    assert any("recovered at step 4; replaying 3" in s for s in lines)
