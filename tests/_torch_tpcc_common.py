"""Helpers shared by the port's TPC-C tests: the reference's state and
``jax.random`` mix draws carried across to the port's tensors."""
import jax
import numpy as np
import torch

from repro.db import workload as jworkload

from repro_torch import convert
from repro_torch._u32 import np_to_i32


def _conv(x):
    """A reference NamedTuple of arrays (nested) as the port's tensors."""
    if hasattr(x, "_fields"):
        return type(x)(*(_conv(y) for y in x))
    return torch.from_numpy(np_to_i32(np.array(x)))


def _port_state(jst):
    return convert.tpcc_state_from_numpy(jax.tree.map(np.asarray, jst),
                                         "cpu")


def _mixed_draws(jcfg, seed, n_rounds, home_w, skew, mix):
    """The reference driver's per-round ``gen_mixed`` draws of the mix
    ``mix`` (None: the standard 45/43/4/4/4), converted."""
    logits = jworkload.zipf_logits(jcfg.n_items, jcfg.skew_alpha)
    key = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        draws.append(_conv(jworkload.gen_mixed(
            sub, jcfg.n_threads, jcfg.n_warehouses, jcfg.n_items,
            jcfg.customers_per_district, home_w, jcfg.dist_degree, logits,
            mix, skew=skew)))
    return draws
