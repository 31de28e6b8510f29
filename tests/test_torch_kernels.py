"""The port's kernel modules against the reference's.

On the CPU the port's plain versions (``repro_torch.kernels.*.ref``) are
held against the reference's plain versions and, once per kernel, against
the reference's Pallas kernel in interpret mode. The cases are built by
``test_torch_gpu.py``, whose card-only tests hold the CUDA kernels against
the same plain versions. Every output is an integer or a bool: the
tolerance is exact equality everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mvcc as jmvcc
from repro.kernels.commit import ops as jcommit_ops
from repro.kernels.commit import ref as jcommit_ref
from repro.kernels.hash_probe import ops as jprobe_ops
from repro.kernels.hash_probe import ref as jprobe_ref

from repro_torch._u32 import np_to_i32
from repro_torch.kernels import _cuda
from repro_torch.kernels.commit import ops as commit_ops
from repro_torch.kernels.commit.ref import fused_commit_ref
from repro_torch.kernels.hash_probe import ops as probe_ops
from repro_torch.kernels.hash_probe.ref import batched_probe_ref, \
    hash_probe_ref

from test_torch_gpu import (COMMIT_OUT, HASH_PROBE_EDGES, PROBE_OUT,
                            check_hash_probe_edges, check_hash_probe_gather,
                            check_lattice, commit_case, flat_commit,
                            hash_probe_edge_case, port_commit,
                            port_hash_probe, port_probe, port_table,
                            probe_case, probe_chain_case, probe_distance, _t)


def _assert_leaves_equal(ref, port, names):
    for name, a, b in zip(names, ref, port):
        a = np_to_i32(np.asarray(a))
        b = b.numpy()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _jax_table(tbl):
    return jmvcc.VersionedTable(**{k: jnp.asarray(v) for k, v in tbl.items()})


@pytest.mark.parametrize("seed,max_probes", [(0, 32), (1, 32), (2, 3)])
def test_batched_probe_ref_matches_reference(seed, max_probes):
    """Port plain version == reference plain version on every lane,
    including out-of-range fallback slots (JAX gather semantics)."""
    case = probe_case(seed, slot_oob=True)
    dk, dv, tbl, ts, fb, lk, km = case
    ref = jprobe_ref.batched_probe_ref(
        jnp.asarray(dk), jnp.asarray(dv), _jax_table(tbl), jnp.asarray(ts),
        jnp.asarray(fb), jnp.asarray(lk), jnp.asarray(km),
        max_probes=max_probes)
    port = port_probe(batched_probe_ref, case, max_probes=max_probes)
    _assert_leaves_equal(ref, port, PROBE_OUT)
    found, src = port[1].numpy(), port[2].numpy()
    # the case reaches every branch of the resolution
    assert found.any() and (~found).any()
    assert {0, 1, 2} <= set(src[found].tolist())
    assert (port[0].numpy()[km] == -1).any()


@pytest.mark.parametrize("n_ts", [4, 9000])
@pytest.mark.parametrize("max_probes", [16, 64])
def test_batched_probe_ref_long_chains_matches_reference(max_probes, n_ts):
    """The card tests' long-chain case: a directory at load 0.9 whose
    chains run past the kernel's window of buckets."""
    case = probe_chain_case(0, n_ts=n_ts)
    dk, dv, tbl, ts, fb, lk, km = case
    assert (probe_distance(case) > 16).sum() > 20
    ref = jprobe_ref.batched_probe_ref(
        jnp.asarray(dk), jnp.asarray(dv), _jax_table(tbl), jnp.asarray(ts),
        jnp.asarray(fb), jnp.asarray(lk), jnp.asarray(km),
        max_probes=max_probes)
    _assert_leaves_equal(ref, port_probe(batched_probe_ref, case,
                                         max_probes=max_probes), PROBE_OUT)


def test_batched_probe_locate_only_matches_reference():
    dk, dv, tbl, ts, fb, lk, km = probe_case(3)
    ref = jprobe_ref.batched_probe_ref(None, None, _jax_table(tbl),
                                       jnp.asarray(ts), jnp.asarray(fb),
                                       None, None)
    port = batched_probe_ref(None, None, port_table(tbl), _t(ts), _t(fb),
                             None, None)
    _assert_leaves_equal(ref, port, PROBE_OUT)


def test_batched_probe_matches_pallas_interpret():
    """One case through the reference's Pallas kernel in interpret mode."""
    case = probe_case(4)
    dk, dv, tbl, ts, fb, lk, km = case
    ker = jprobe_ops.batched_probe(
        jnp.asarray(dk), jnp.asarray(dv), _jax_table(tbl), jnp.asarray(ts),
        jnp.asarray(fb), jnp.asarray(lk), jnp.asarray(km), max_probes=32,
        bq=32, interpret=True)
    _assert_leaves_equal(ker, port_probe(probe_ops.batched_probe, case),
                         PROBE_OUT)


@pytest.mark.parametrize("seed,max_probes", [(0, 32), (1, 32), (2, 3)])
@pytest.mark.parametrize("snapshot", ["as_drawn", "zero"])
def test_hash_probe_ref_matches_reference(seed, max_probes, snapshot):
    """Port plain version == reference plain version: a missing or
    invalidated key is slot -1 with src = pos = 0, found keys resolve in
    every region, and under the zero snapshot hit keys find no version."""
    case = probe_case(seed)
    if snapshot == "zero":
        case = case[:3] + (np.zeros_like(case[3]),) + case[4:]
    dk, dv, tbl, ts, fb, lk, km = case
    ref = jprobe_ref.hash_probe_ref(
        jnp.asarray(dk), jnp.asarray(dv), _jax_table(tbl), jnp.asarray(ts),
        jnp.asarray(lk), max_probes=max_probes)
    port = port_hash_probe(hash_probe_ref, case, max_probes=max_probes)
    _assert_leaves_equal(ref, port, PROBE_OUT)
    slot, found, src = (x.numpy() for x in port[:3])
    assert (slot == -1).any() and found.any()
    if snapshot == "zero":
        assert (~found & (slot >= 0)).any()
    elif max_probes == 32:
        assert {0, 1, 2} <= set(src[found].tolist())
    if max_probes == 32:
        check_hash_probe_gather(case, port)


def test_hash_probe_matches_pallas_interpret():
    """One case through the reference's Pallas kernel in interpret mode."""
    case = probe_case(4)
    dk, dv, tbl, ts, fb, lk, km = case
    ker = jprobe_ops.hash_probe(
        jnp.asarray(dk), jnp.asarray(dv), _jax_table(tbl), jnp.asarray(ts),
        jnp.asarray(lk), max_probes=32, bq=32, interpret=True)
    _assert_leaves_equal(ker, port_hash_probe(probe_ops.hash_probe, case),
                         PROBE_OUT)


@pytest.mark.parametrize("n_buckets,max_probes", HASH_PROBE_EDGES)
def test_hash_probe_ref_edges_match_reference(n_buckets, max_probes):
    """The card tests' edge cases of the tile probe (1, 3, 15 and 64
    buckets at 1, 17 and 32 probes): the port's plain version equals the
    reference's, and the cases reach what the card tests rely on."""
    case = hash_probe_edge_case(0, n_buckets)
    dk, dv, tbl, ts, fb, lk, km = case
    ref = jprobe_ref.hash_probe_ref(
        jnp.asarray(dk), jnp.asarray(dv), _jax_table(tbl), jnp.asarray(ts),
        jnp.asarray(lk), max_probes=max_probes)
    port = port_hash_probe(hash_probe_ref, case, max_probes=max_probes)
    _assert_leaves_equal(ref, port, PROBE_OUT)
    check_hash_probe_gather(case, port, max_probes=max_probes)
    check_hash_probe_edges(n_buckets, max_probes, port)


@pytest.mark.parametrize("n_buckets,max_probes", [(3, 17), (64, 32)])
def test_hash_probe_edges_match_pallas_interpret(n_buckets, max_probes):
    """Two edge cases through the reference's Pallas kernel in interpret
    mode: a directory smaller than the probe budget, and the 64-bucket
    one."""
    case = hash_probe_edge_case(0, n_buckets)
    dk, dv, tbl, ts, fb, lk, km = case
    ker = jprobe_ops.hash_probe(
        jnp.asarray(dk), jnp.asarray(dv), _jax_table(tbl), jnp.asarray(ts),
        jnp.asarray(lk), max_probes=max_probes, bq=32, interpret=True)
    _assert_leaves_equal(ker, port_hash_probe(probe_ops.hash_probe, case,
                                              max_probes=max_probes),
                         PROBE_OUT)


# ---------------------------------------------------------- commit -------
@pytest.mark.parametrize("wrap_seed", [0, 1])
def test_fused_commit_ref_matches_reference(wrap_seed):
    case = commit_case(wrap_seed)
    tbl, args = case
    ref = jcommit_ref.fused_commit_ref(
        _jax_table(tbl), *(jnp.asarray(a) for a in args))
    port = port_commit(fused_commit_ref, case)
    _assert_leaves_equal(flat_commit(ref), port, COMMIT_OUT)
    check_lattice(port)


def test_fused_commit_matches_pallas_interpret():
    case = commit_case(2)
    tbl, args = case
    ker = jcommit_ops.fused_commit(
        _jax_table(tbl), *(jnp.asarray(a) for a in args), interpret=True)
    _assert_leaves_equal(flat_commit(ker),
                         port_commit(commit_ops.fused_commit, case),
                         COMMIT_OUT)


def test_fused_commit_shared_memory_arithmetic():
    """A block keeps 25 bytes for each request of its eighth of the round,
    padded to 16: the main path's 960 requests take 3,008 bytes of shared
    memory, and up to 74,376 requests the lane state fits there (beyond,
    the kernel keeps it in a global scratch)."""
    assert commit_ops.smem_bytes(960) == 3008
    assert commit_ops.smem_bytes(74_376) <= _cuda.MAX_SMEM \
        < commit_ops.smem_bytes(74_377)


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers run the plain version: no launch."""
    counts = lambda: (probe_ops.batched_probe.launches,
                      probe_ops.hash_probe.launches,
                      commit_ops.fused_commit.launches)
    before = counts()
    port_probe(probe_ops.batched_probe, probe_case(5))
    port_hash_probe(probe_ops.hash_probe, probe_case(5))
    port_commit(commit_ops.fused_commit, commit_case(3))
    assert counts() == before
