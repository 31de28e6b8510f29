"""The port's ``launch/`` analogues and shape-only specs against the
reference's, on the CPU, with no allocation.

``Model.param_shapes``, ``input_specs`` and ``cache_specs`` (on torch's
``meta`` device) equal the reference's ``jax.eval_shape`` trees leaf for
leaf, in shape and dtype, for all ten architectures at full width; the
partition rules (``launch/sharding.py``) equal the reference's on
``AbstractMesh`` (16, 16) and (2, 16, 16) for every architecture and
shape under the ``baseline`` and ``opt`` policies. All of it is exact:
shapes, dtypes and specs are not numbers that round. The op counter is
held on miniature cases with known answers (mirroring
``tests/test_hlostats.py``), the shape-only mesh drives
``models/common``'s mesh reads and ``moe.apply_moe``'s choice of
dispatch, and ``examples/quickstart_torch.py --device cpu`` runs to its
end.
"""
import functools
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro import policy as jpolicy
from repro.configs import ARCH_IDS, get_arch as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import sharding as jsharding
from repro.models import build as jbuild

from repro_torch import _tree, policy
from repro_torch.configs import SHAPES, get_arch, shape_applies
from repro_torch.launch import hlostats, mesh as tmesh, sharding
from repro_torch.models import api, common, moe

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_SHAPES = ("decode_32k", "long_500k")


def _jflat(tree):
    """``{key string: (shape, dtype) or spec tuple}`` of a reference
    tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {jax.tree_util.keystr(k): tuple(v)
            if isinstance(v, PartitionSpec)
            else (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in leaves}


def _tflat(tree):
    """The same of a port tree (specs, tensors or ``sharding.Shape``)."""
    return {k: tuple(v) if isinstance(v, sharding.P)
            else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _tree.items(tree)}


@functools.lru_cache(maxsize=None)
def _ref(aid):
    """The reference's parameter shapes and caches (eval_shape)."""
    m = jbuild(jget(aid))
    return m.param_shapes(), {
        s: m.cache_specs(JSHAPES[s]) for s in CACHE_SHAPES
        if shape_applies(get_arch(aid), SHAPES[s])[0]}


@functools.lru_cache(maxsize=None)
def _port(aid):
    """The port's, in the reference's layout (meta tensors throughout)."""
    m = api.build(get_arch(aid))
    params = m.param_shapes()
    assert all(p.device.type == "meta" for p in params.parameters())
    caches = {}
    for s in CACHE_SHAPES:
        if shape_applies(m.cfg, SHAPES[s])[0]:
            c = m.cache_specs(SHAPES[s])
            assert all(t.device.type == "meta" for t in _tree.leaves(c))
            caches[s] = sharding.cache_tree(m.cfg, c)
    return sharding.param_tree(params), caches


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_specs_equal_the_reference_at_full_width(aid):
    jp, jc = _ref(aid)
    tp, tc = _port(aid)
    assert _tflat(tp) == _jflat(jp)
    assert sorted(tc) == sorted(jc)
    for s in jc:
        assert _tflat(tc[s]) == _jflat(jc[s]), s
    jm, tm = jbuild(jget(aid)), api.build(get_arch(aid))
    for s in SHAPES:
        specs = tm.input_specs(SHAPES[s])
        assert all(t.device.type == "meta" for t in specs.values())
        assert _tflat(specs) == _jflat(jm.input_specs(JSHAPES[s])), s


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_partition_specs_equal_the_reference(aid):
    jp, jc = _ref(aid)
    tp, tc = _port(aid)
    prev = jpolicy.current(), policy.current()
    try:
        for shape, names in MESHES.values():
            am, tm = AbstractMesh(shape, names), tmesh.Mesh(names, shape)
            for pol in ("baseline", "opt"):
                jpolicy.set_policy(pol)
                policy.set_policy(pol)
                jps = jsharding.param_pspecs(jp, am)
                tps = sharding.param_pspecs(tp, tm)
                assert _tflat(tps) == _jflat(jps), (shape, pol)
                assert _tflat(sharding.opt_pspecs(tps)) \
                    == _jflat(jsharding.opt_pspecs(jps))
                for s in SHAPES:
                    assert _tflat(sharding.batch_pspecs(
                        get_arch(aid), SHAPES[s], tm)) == _jflat(
                        jsharding.batch_pspecs(jget(aid), JSHAPES[s], am))
                for s in jc:
                    assert _tflat(sharding.cache_pspecs(
                        get_arch(aid), tc[s], SHAPES[s], tm)) == _jflat(
                        jsharding.cache_pspecs(jget(aid), jc[s],
                                               JSHAPES[s], am)), s
    finally:
        jpolicy.set_policy(prev[0])
        policy.set_policy(prev[1])


def test_per_device_bytes_divide_by_the_spec():
    m = tmesh.make_production_mesh()
    leaf = sharding.Shape((64, 32, 6), torch.bfloat16)
    spec = sharding.P("model", "data", None)
    assert sharding.shard_shape(leaf.shape, spec, m) == (4, 2, 6)
    assert sharding.per_device_bytes({"w": leaf}, {"w": spec}, m) \
        == 4 * 2 * 6 * 2
    mp = tmesh.make_production_mesh(multi_pod=True)
    assert sharding.shard_shape((64, 8), sharding.P(("pod", "data")), mp) \
        == (2, 8)
    one = tmesh.make_host_mesh()
    assert sharding.per_device_bytes({"w": leaf}, {"w": spec}, one) \
        == 64 * 32 * 6 * 2


# -------------------------------------------------- the op counter ----
def _count(fn):
    return hlostats.count(fn)[1]


def test_counter_mm_flops_and_bytes():
    a = torch.zeros(64, 128, device="meta")
    b = torch.zeros(128, 32, device="meta")
    st = _count(lambda: a @ b)
    assert st.flops == 2 * 64 * 32 * 128
    assert st.hbm_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert st.by_op["mm"]["calls"] == 1


def test_counter_counts_each_product_of_a_loop():
    x = torch.zeros(8, 16, device="meta")
    w = torch.zeros(16, 16, device="meta")

    def loop():
        y = x
        for _ in range(7):
            y = y @ w
        return y
    st = _count(loop)
    assert st.flops == 7 * 2 * 8 * 16 * 16
    assert st.by_op["mm"]["calls"] == 7


def test_counter_views_are_free():
    x = torch.zeros(8, 16, device="meta")
    st = _count(lambda: x.reshape(16, 8).T[2:].unsqueeze(0).expand(3, 6, 16))
    assert st.flops == 0 and st.hbm_bytes == 0 and not st.by_op


def test_counter_einsum_counts_once():
    q = torch.zeros(2, 4, 8, 16, device="meta")
    k = torch.zeros(2, 4, 10, 16, device="meta")
    st = _count(lambda: torch.einsum("bhqd,bhkd->bhqk", q, k))
    assert st.flops == 2 * 2 * 4 * 8 * 10 * 16
    assert sum(r["calls"] for n, r in st.by_op.items() if r["flops"]) == 1


def test_counter_conv():
    x = torch.zeros(1, 4, 8, 8, device="meta")
    w = torch.zeros(6, 2, 3, 3, device="meta")     # 2 groups
    st = _count(lambda: torch.nn.functional.conv2d(x, w, groups=2))
    assert st.flops == 2 * (1 * 6 * 6 * 6) * 2 * 9


def test_counter_gathers_and_partial_writes_move_their_slice():
    table = torch.zeros(1000, 16, device="meta")
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    st = _count(lambda: table[idx])
    assert st.hbm_bytes == 2 * 4 * 16 * 4 + 4 * 8
    vals = torch.zeros(4, 16, device="meta")
    st = _count(lambda: table.index_put_((idx,), vals))
    assert st.hbm_bytes == 2 * 4 * 16 * 4 + 4 * 8


def test_counter_sees_the_backward_pass():
    a = torch.zeros(8, 16, device="meta", requires_grad=True)
    b = torch.zeros(16, 4, device="meta", requires_grad=True)
    st = _count(lambda: torch.autograd.grad((a @ b).sum(), (a, b)))
    assert st.flops == 3 * 2 * 8 * 16 * 4


# ------------------------------------------------ the mesh context ----
def test_mesh_context_drives_the_mesh_reads():
    assert common._mesh_axes() is None and common._axis_size("data") == 1
    m = tmesh.make_production_mesh(multi_pod=True)
    assert (m.size, tmesh.dp_axes(m)) == (512, ("pod", "data"))
    with m:
        axes = common._mesh_axes()
        assert axes == ("pod", "data", "model")
        assert common._dp(axes) == ("pod", "data")
        assert common._axis_size(common._dp(axes)) == 32
        with tmesh.make_host_mesh(2):
            assert common._axis_size("model") == 2
        assert tmesh.current() is m
    assert tmesh.current() is None
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.dp_axes(tmesh.make_host_mesh()) == ("data",)


def test_apply_moe_selects_the_sharded_dispatch_as_the_reference(
        monkeypatch):
    calls = []
    real = moe.apply_moe_sharded
    monkeypatch.setattr(moe, "apply_moe_sharded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    p = moe.init_moe(16, 32, 4, torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    prev = policy.current()
    try:
        with torch.no_grad():
            for pol, mesh, T, want in (
                    ("opt", tmesh.Mesh(("data", "model"), (4, 1)), 8, 1),
                    ("opt", tmesh.Mesh(("data", "model"), (2, 2)), 8, 1),
                    ("opt", None, 8, 0),                  # no mesh
                    ("baseline", tmesh.Mesh(("data", "model"), (4, 1)), 8,
                     0),
                    ("opt", tmesh.Mesh(("data", "model"), (3, 1)), 8, 0),
                    ("opt", tmesh.Mesh(("data", "model"), (1, 3)), 8, 0)):
                policy.set_policy(pol)
                calls.clear()
                if mesh is None:
                    moe.apply_moe(p, x[:T], top_k=2)
                else:
                    with mesh:
                        moe.apply_moe(p, x[:T], top_k=2)
                assert len(calls) == want, (pol, mesh)
    finally:
        policy.set_policy(prev)


def test_quickstart_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "quickstart OK"
    assert "conservation holds" in out.stdout
