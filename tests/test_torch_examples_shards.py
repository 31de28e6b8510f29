"""The port's TPC-C demo over memory servers against the reference demo's
``--shards`` run, on the CPU.

The reference demo runs as a program (it forces host devices and re-execs
itself to set them) at ``--shards 2``. The port's ``run_sharded`` runs, in
each Fig. 5 locality deployment, on that demo's pool (``PRNGKey(0)``, the
partitioned oracle) and draws (``PRNGKey(1)``, each thread at its home
warehouse), carried across, and must print every line the reference
prints: the commits, the steady-state abort rate, the machine-local share
and the projection at 2·S machines, then the per-type counts.
"""
import dataclasses
import os
import subprocess
import sys

import jax

from repro.core import locality as jlocality
from repro.core.tsoracle import PartitionedVectorOracle as JPartitioned
from repro.db import tpcc as jtpcc

from repro_torch.db import tpcc

from _torch_examples_common import EXAMPLES, _example
from _torch_tpcc_common import _mixed_draws, _port_state

SHARD_ARGS = ["--shards", "2", "--rounds", "2", "--threads", "4"]

demo = _example("tpcc_demo_torch")


def _start_reference():
    """The reference demo at ``SHARD_ARGS``, started as a program."""
    src = str(EXAMPLES.parent / "src")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=src + (os.pathsep + path
                                             if path else ""))
    return subprocess.Popen(
        [sys.executable, str(EXAMPLES / "tpcc_demo.py")] + SHARD_ARGS,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _port_lines():
    """The port's ``run_sharded`` in both deployments on the reference
    demo's pool and draws: the lines it prints."""
    args = demo.parse_args(SHARD_ARGS)
    S = args.shards
    lines = []
    for mode, layout in demo.MODES:
        cfg = demo.sharded_config(args, layout)
        jcfg = jtpcc.TPCCConfig(**dataclasses.asdict(cfg))
        T = cfg.n_threads
        _, jst = jtpcc.init_tpcc(jcfg, JPartitioned(T, n_parts=S),
                                 jax.random.PRNGKey(0))
        home = jlocality.thread_homes(T, cfg.n_warehouses)
        draws = _mixed_draws(jcfg, 1, args.rounds, home, None, None)
        stats, printed = demo.run_sharded(
            cfg, tpcc.make_layout(cfg), _port_state(jst), S,
            lambda r: draws[r], args.rounds, mode, "cpu")
        assert stats.total_attempts == args.rounds * T
        lines += printed
    return lines


def test_demo_sharded_prints_the_reference_demos_lines():
    proc = _start_reference()     # runs while the port's side runs here
    try:
        lines = _port_lines()
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    ref = out.splitlines()
    assert ref[0].startswith("# note: --shards pins warehouses")
    assert ref[1:-1] == lines
    assert ref[-1] == "tpcc_demo OK"
