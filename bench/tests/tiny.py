"""A checkout in miniature for the CPU tests: the benchmark's files with
tiny configurations and draw horizons, cells found by name as in the real
one."""
from __future__ import annotations

import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"n_warehouses": 2, "customers_per_district": 30, "n_items": 200,
         "n_threads": 8}
CELLS = {"t1.mix": ("tpcc-1server", "mix"), "t4.mix": ("tpcc-4server", "mix"),
         "t1.neworder": ("tpcc-1server", "neworder")}


def make_root(tmp: Path, cells=CELLS, **overrides) -> Path:
    """A checkout at ``tmp`` whose cells ``cells`` ({name: (config,
    traffic)}) run the real configurations at tiny sizes (four servers:
    four warehouses), with the configuration keys ``overrides``."""
    (tmp / "bench" / "configs").mkdir(parents=True)
    (tmp / "bench" / "traffic").mkdir(parents=True)
    (tmp / "bench" / "cells").mkdir(parents=True)
    os.symlink(ROOT / "src", tmp / "src")
    os.symlink(ROOT / "bench" / "metrics", tmp / "bench" / "metrics")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs, workloads = {}, []
    for name, (config, traffic) in cells.items():
        cfg = json.loads((ROOT / "bench" / "configs"
                          / f"{config}.json").read_text())
        cfg.update(SIZES, name=config, **overrides)
        if cfg["memory_servers"] > 1:
            cfg["n_warehouses"] = 2 * cfg["memory_servers"]
        (tmp / "bench" / "configs" / f"{config}.json").write_text(
            json.dumps(cfg))
        configs[config] = dict(name=config, source="tiny",
                               file=f"bench/configs/{config}.json",
                               reduced=[], why="tiny")
        (tmp / "bench" / "traffic" / f"{traffic}.json").write_text(
            (ROOT / "bench" / "traffic" / f"{traffic}.json").read_text())
        real = next(w["name"] for w in bench["workloads"]
                    if (w["config"], w["traffic"]) == (config, traffic))
        amounts = json.loads((ROOT / "bench" / "cells"
                              / f"{real}.json").read_text())
        amounts.update(warmup_rounds=4, trace_rounds=5, horizon_rounds=400)
        (tmp / "bench" / "cells" / f"{name}.json").write_text(
            json.dumps(amounts))
        workloads.append(dict(name=name, config=config, traffic=traffic,
                              chips=1, why="tiny"))
    bench["configs"], bench["workloads"] = list(configs.values()), workloads
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
