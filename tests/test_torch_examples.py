"""The port's TPC-C demo against the reference's, on the CPU
(``test_torch_examples_shards.py`` holds the demo against the reference's
``--shards`` run, ``test_torch_examples_serve.py`` the serve example).

``examples/tpcc_demo_torch.py`` runs the reference demo's pool (loaded
from ``PRNGKey(0)``) and draws (``PRNGKey(1)``), carried across, and must
print every line the reference demo prints, apart from the wall time; over
2 memory servers each locality deployment must give the per-type counts
of its own one-server run. The script runs as a program with ``--device
cpu`` and ends with its ``OK`` line, and refuses the CPU unless asked.
"""
import dataclasses
import re

import jax
import pytest
import torch

from repro.core.tsoracle import VectorOracle as JOracle
from repro.db import tpcc as jtpcc

from repro_torch.core import locality
from repro_torch.core.tsoracle import PartitionedVectorOracle, VectorOracle
from repro_torch.db import tpcc, workload

from _torch_examples_common import _example, _reference_output, run_program
from _torch_tpcc_common import _mixed_draws, _port_state

DEMO_ARGS = ["--rounds", "2", "--threads", "8", "--warehouses", "8"]


demo = _example("tpcc_demo_torch")


def _without_wall_time(lines):
    return [re.sub(r" in [0-9.]+s$", " in <t>s", ln) for ln in lines]


def test_demo_prints_the_reference_demos_lines(monkeypatch):
    ref = _reference_output("tpcc_demo.py", DEMO_ARGS, monkeypatch)
    args = demo.parse_args(DEMO_ARGS)
    cfg = demo.single_config(args)
    jcfg = jtpcc.TPCCConfig(**dataclasses.asdict(cfg))
    T = cfg.n_threads
    lay, jst = jtpcc.init_tpcc(jcfg, JOracle(T), jax.random.PRNGKey(0))
    draws = _mixed_draws(jcfg, 1, args.rounds, None, None, None)
    stats, lines = demo.run_single(cfg, lay, _port_state(jst),
                                   VectorOracle(T), lambda r: draws[r],
                                   args.rounds, "cpu")
    assert lines[0].endswith("s") and " in " in lines[0]
    assert _without_wall_time(ref[:-1]) == _without_wall_time(lines)
    assert ref[-1] == "tpcc_demo OK"
    assert stats.total_attempts == args.rounds * T


@pytest.mark.parametrize("mode,layout", demo.MODES)
def test_demo_sharded_equals_its_one_server_run(mode, layout):
    args = demo.parse_args(["--shards", "2"] + DEMO_ARGS)
    cfg = demo.sharded_config(args, layout)
    T = cfg.n_threads
    oracle = PartitionedVectorOracle(T, n_parts=args.shards)
    home = locality.thread_homes(T, cfg.n_warehouses)
    lay, st = demo.load(cfg, oracle, args.seed, "cpu")
    stats, lines = demo.run_sharded(
        cfg, lay, st, args.shards, demo.draws(cfg, args.seed + 1, "cpu",
                                              home), args.rounds, mode,
        "cpu")
    lay1, st1 = demo.load(cfg, oracle, args.seed, "cpu")
    _, one = tpcc.run_mixed_rounds(
        cfg, lay1, st1, oracle, demo.draws(cfg, args.seed + 1, "cpu", home),
        args.rounds, device="cpu")
    for n in workload.TXN_TYPES:
        assert (stats.attempts[n], stats.commits[n]) \
            == (one.attempts[n], one.commits[n]), n
    assert 0.0 < stats.local_fraction <= 1.0
    assert lines[0].startswith(f"{args.shards}-server mesh, {mode:9s}: "
                               f"{stats.total_commits}/")
    assert lines[1] == demo.mix_line(stats)


@pytest.mark.parametrize("argv", [
    DEMO_ARGS, ["--shards", "2", "--rounds", "2", "--threads", "4"]],
    ids=["one-server", "shards"])
def test_demo_runs_as_a_program_on_the_cpu(argv):
    run_program("tpcc_demo_torch.py", argv, "tpcc_demo OK")


def test_demo_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main([])
