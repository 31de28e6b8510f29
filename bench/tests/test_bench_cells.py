"""The benchmark's files: every cell of BENCHMARK.json resolves by name to
its configuration, traffic, amounts of work and metric files; the file
keeps to its contract; a cell is added by adding files alone; a
configuration that states what the harness does not implement is
refused."""
import json
import re

import pytest

from bench import cell, run
from bench.tests import tiny

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    spec = cell.load(ROOT, name)
    assert spec.config["name"] == spec.cell["config"]
    assert spec.traffic["driver"] in ("mixed", "neworder")
    for kind in ("end_to_end", "per_layer"):
        for m in run.metrics_of(spec, kind):
            assert callable(run.reader(ROOT, m["name"]))
    rcfg = cell.run_config(spec.config, spec.work)
    for k in cell.PROGRAM_KEYS + cell.RUN_KEYS:
        assert k in rcfg, k
    w = spec.work
    need = w["warmup_rounds"] + w["trace_rounds"] \
        + w["window_rounds_per_second"] * BENCH["run_seconds"]
    assert need <= w["horizon_rounds"] == w["extents"]["orders_per_thread"]


@pytest.mark.parametrize("change", [
    {"oracle": "compressed"}, {"journal": True},
    {"layout": "warehouse_major"}, {"routing": "home"},
    {"skew_alpha": 0.9}, {"memory_servers": 4}])
def test_a_configuration_the_harness_does_not_implement_is_refused(change):
    spec = cell.load(ROOT, CELLS[0])
    cell.run_config(spec.config, spec.work)
    with pytest.raises(ValueError, match=next(iter(change))):
        cell.run_config(dict(spec.config, **change), spec.work)


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    used = {w["config"] for w in BENCH["workloads"]}
    assert set(names) == used and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench" / "cells" / f"{w['name']}.json").exists()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] in layers
    for w in CELLS:
        spec = cell.load(ROOT, w)
        got = [m["name"] for m in run.metrics_of(spec, "end_to_end")]
        assert "setup_s" in got and len(got) >= 2
        assert run.metrics_of(spec, "per_layer")
        for m in run.metrics_of(spec, "per_layer"):
            assert m["moves"] in got, (w, m["name"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_cell_is_added_by_files_alone(tmp_path, capsys):
    root = tiny.make_root(tmp_path, {"t1.mix": ("tpcc-1server", "mix")})
    cfg = json.loads((root / "bench/configs/tpcc-1server.json").read_text())
    cfg.update(name="tpcc-wide", n_threads=12)
    (root / "bench/configs/tpcc-wide.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "bench/traffic/mix.json").read_text())
    tr["mix"] = {"neworder": 0.6, "payment": 0.4}
    (root / "bench/traffic/heavy.json").write_text(json.dumps(tr))
    (root / "bench/cells/tpcc-wide.heavy.json").write_text(
        (root / "bench/cells/t1.mix.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tpcc-wide", source="tiny",
                                 file="bench/configs/tpcc-wide.json",
                                 reduced=[], why="tiny"))
    bench["workloads"].append(dict(name="tpcc-wide.heavy", config="tpcc-wide",
                                   traffic="heavy", chips=1, why="tiny"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc = run.main(["--workload", "tpcc-wide.heavy", "--seed", "3",
                   "--seconds", "0.5", "--trace", "0"], root=root,
                  device="cpu")
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"txn_per_s", "setup_s"}


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_device_time_per_commit_reads_nothing_without_device_ops():
    read = run.reader(ROOT, "device_us_per_txn")
    stats = {"commits.neworder": 30, "commits.payment": 20, "attempts": 60}
    trace = {"device_ops": {}, "busy_s": 0.0}
    assert read({"trace": trace, "trace_stats": stats}) is None
    trace = {"device_ops": {"k": (0.004, 9)}, "busy_s": 0.005}
    assert read({"trace": trace, "trace_stats": stats}) == \
        pytest.approx(100.0)
    assert read({"trace": trace, "trace_stats": {"commits": 0}}) is None
