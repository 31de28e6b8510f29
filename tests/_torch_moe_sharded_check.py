"""Subprocess body: the port's sharded MoE dispatch against the
reference's ``apply_moe_sharded`` on 4 host devices.

The reference runs under the ``opt`` policy inside a (4, 1) and a (2, 2)
``("data", "model")`` device mesh; the port runs the same parameters and
tokens under its own ``opt`` policy inside shape-only meshes of the same
shapes, in float32 and in bfloat16, at a capacity factor that drops
choices (local capacity per data shard, so the drops differ from the
global dispatch's). ``load`` and ``dropped_fraction`` must be equal;
``y`` and ``aux_loss`` within the stated tolerances.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import policy as jpolicy  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch import convert, policy  # noqa: E402
from repro_torch.kernels.tolerance import LM_TOL  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

T, D, F, E, K = 64, 32, 64, 4, 2
CF = 1.0                  # drops choices, locally and globally
# y: float32 differs in summation order only (read: 2e-7); bfloat16 by the
# kernels' bfloat16 rule, atol = rtol (the einsums round where XLA's do not)
Y_TOL = {"float32": 2e-5, "bfloat16": LM_TOL["bfloat16"]}
AUX_RTOL = 1e-5


def port_moe(p, dtype):
    m = moe.MoE(D, F, E, dtype, device="cpu")
    with torch.no_grad():
        for name in ("router", "w_gate", "w_in", "w_out"):
            getattr(m, name).copy_(convert.tensor_from_numpy(
                np.asarray(p[name])))
    return m


def check(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    p = jmoe.init_moe(jax.random.PRNGKey(2), D, F, E, jdt)
    x = jax.random.normal(jax.random.PRNGKey(3), (T, D), jnp.float32) \
        .astype(jdt)
    tp = port_moe(p, getattr(torch, dtype))
    tx = convert.tensor_from_numpy(np.asarray(x))
    _, gst = jax.jit(lambda p, x: jmoe._apply_moe_global(
        p, x, top_k=K, capacity_factor=CF))(p, x)
    for shape in ((4, 1), (2, 2)):
        jpolicy.set_policy("opt")
        with jax.make_mesh(shape, ("data", "model")):
            y, st = jax.jit(lambda p, x: jmoe.apply_moe(
                p, x, top_k=K, capacity_factor=CF))(p, x)
        policy.set_policy("opt")
        with Mesh(("data", "model"), shape), torch.no_grad():
            ty, tst = moe.apply_moe(tp, tx, top_k=K, capacity_factor=CF)
        what = f"{dtype} {shape}"
        drop = float(st.dropped_fraction)
        assert drop > 0 and drop != float(gst.dropped_fraction), (
            what, drop, float(gst.dropped_fraction))
        np.testing.assert_array_equal(tst.load.numpy(), np.asarray(st.load))
        assert float(tst.dropped_fraction) == drop, (
            what, float(tst.dropped_fraction), drop)
        yj = np.asarray(y.astype(jnp.float32))
        yp = ty.float().numpy()
        tol = Y_TOL[dtype]
        np.testing.assert_allclose(yp, yj, rtol=tol, atol=tol, err_msg=what)
        np.testing.assert_allclose(float(tst.aux_loss), float(st.aux_loss),
                                   rtol=AUX_RTOL, err_msg=what)
        print(f"apply_moe_sharded {what}: load {tst.load.tolist()}, "
              f"dropped {drop} (global {float(gst.dropped_fraction)}), "
              f"max |dy| {np.abs(yp - yj).max():.3g} OK")


if __name__ == "__main__":
    assert len(jax.devices()) == 4, jax.devices()
    for dt in ("float32", "bfloat16"):
        check(dt)
    print("MOE-SHARDED-ALL-OK")
