"""The port's sharded MoE dispatch (``moe.apply_moe_sharded``), on the CPU.

Against the reference: ``tests/_torch_moe_sharded_check.py`` runs the
reference's ``shard_map`` dispatch on a (4, 1) and a (2, 2) host-device
mesh and the port on shape-only meshes of the same shapes, in one
subprocess (it needs 4 forced host devices, which must not leak into this
process's JAX), at a capacity that drops choices: ``load`` and
``dropped_fraction`` exact, ``y`` within float32 2e-5 or the kernels'
bfloat16 rule (2e-2, atol = rtol).

In process: one shard and one model slice is the global dispatch bit for
bit; at a dropless capacity any mesh gives the global dispatch's routing
exactly and its ``y`` within float32 1e-6 (the products' rows are
grouped otherwise); the dry run reaches the sharded dispatch under the
``opt`` policy, with the local capacity's bucket rows.
"""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import policy
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import moe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, D, F, E, K = 64, 32, 64, 4, 2
F32_TOL = 1e-6


@pytest.mark.slow
def test_sharded_dispatch_matches_the_reference_on_4_devices():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_moe_sharded_check.py")],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    assert "MOE-SHARDED-ALL-OK" in out.stdout


def _moe(dtype=torch.float32):
    p = moe.init_moe(D, F, E, dtype, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(T, D, generator=torch.Generator().manual_seed(1)) \
        .to(dtype)
    return p, x


def _run(p, x, shape, cf, pol="opt"):
    prev = policy.current()
    policy.set_policy(pol)
    try:
        with torch.no_grad():
            if shape is None:
                return moe.apply_moe(p, x, top_k=K, capacity_factor=cf)
            with Mesh(("data", "model"), shape):
                return moe.apply_moe(p, x, top_k=K, capacity_factor=cf)
    finally:
        policy.set_policy(prev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_shard_is_the_global_dispatch_bit_for_bit(dtype):
    p, x = _moe(dtype)
    for cf in (1.0, 2.0):
        yg, sg = _run(p, x, None, cf)
        ys, ss = _run(p, x, (1, 1), cf)
        assert torch.equal(ys, yg)
        assert torch.equal(ss.load, sg.load)
        assert float(ss.dropped_fraction) == float(sg.dropped_fraction)
        assert float(ss.aux_loss) == float(sg.aux_loss)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4), (2, 1, 2)])
def test_dropless_meshes_route_as_the_global_dispatch(shape):
    p, x = _moe()
    cf = E / K                     # dropless: C_l ≥ T_l · k
    yg, sg = _run(p, x, None, cf)
    if len(shape) == 3:
        prev = policy.current()
        policy.set_policy("opt")
        try:
            with torch.no_grad(), Mesh(("pod", "data", "model"), shape):
                ys, ss = moe.apply_moe(p, x, top_k=K, capacity_factor=cf)
        finally:
            policy.set_policy(prev)
    else:
        ys, ss = _run(p, x, shape, cf)
    assert float(ss.dropped_fraction) == float(sg.dropped_fraction) == 0.0
    assert torch.equal(ss.load, sg.load)
    torch.testing.assert_close(ys, yg, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(ss.aux_loss, sg.aux_loss, rtol=F32_TOL,
                               atol=0)


def test_local_capacity_drops_within_each_shard():
    """Capacity 1.0 of 16 tokens a shard: ``C_l = 8``; a shard whose
    choices of one expert pass 8 drops the rest, whatever the others
    hold. Held against a count per shard."""
    p, x = _moe()
    ys, ss = _run(p, x, (4, 1), 1.0)
    Tl, C = T // 4, int(1.0 * (T // 4) * K / E)
    probs = torch.softmax(x.float() @ p.router, -1)
    idx = moe.top_k_choices(probs, K)[1].reshape(4, Tl * K)
    kept = sum(min(int((idx[s] == e).sum()), C)
               for s in range(4) for e in range(E))
    assert float(ss.dropped_fraction) == pytest.approx(
        1 - kept / (T * K), abs=0)
    assert torch.equal(ss.load, torch.bincount(idx.reshape(-1),
                                               minlength=E).int())
    _, sg = _run(p, x, None, 1.0)
    assert float(ss.dropped_fraction) > float(sg.dropped_fraction)


def test_dry_run_counts_the_local_capacity():
    """Reduced mixtral's prefill (B 2 × S 64 = 128 tokens) on the
    multi-pod mesh: 32 data shards of 4 tokens, ``C_l = int(1.25·4·2/4) =
    2``, so 32·2 = 64 bucket rows an expert where the global dispatch has
    ``int(1.25·128·2/4) = 80``: 16 rows of 3 products fewer a MoE layer."""
    cfg = reduced(get_arch("mixtral-8x22b"))
    shape = ShapeConfig("p", 64, 2, "prefill")
    mesh = make_production_mesh(multi_pod=True)
    prev = policy.current()
    try:
        policy.set_policy("baseline")
        base = dryrun.count_cell(cfg, shape, mesh)["hlo_flops"]
        policy.set_policy("opt")
        opt = dryrun.count_cell(cfg, shape, mesh)["hlo_flops"]
    finally:
        policy.set_policy(prev)
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
    assert base - opt == n_moe * 3 * 2 * cfg.n_experts * 16 \
        * cfg.d_model * cfg.d_ff
