"""A cell of the benchmark: its files found by name, and the program
deployed and driven as the configuration and the traffic say.

``BENCHMARK.json`` names each cell's configuration and traffic; the
configuration is ``bench/configs/<config>.json``, the traffic
``bench/traffic/<traffic>.json`` and the cell's amounts of work (warm-up,
window, traced rounds, draw horizon) ``bench/cells/<workload>.json``. The
program (``repro_torch``) is imported by the caller and handed in as
``prog``.
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import NamedTuple

import torch

# the keys of a configuration file that are the program's TPCCConfig fields
PROGRAM_KEYS = ("n_warehouses", "customers_per_district", "n_items",
                "n_threads", "dist_degree", "n_old_versions", "n_overflow",
                "layout", "key_addressed", "fused_commit", "batched_probe")
WRITE_ROUNDS = ("neworder_round", "payment_round", "delivery_round")
READ_ROUNDS = ("orderstatus_round", "stocklevel_round")
# each sub-round function the drivers call, by the name of its
# single-server form, and the outcome fields it returns
OUTCOMES = {"neworder_round": ("committed", "snapshot_miss", "o_id"),
            "payment_round": ("committed", "snapshot_miss"),
            "delivery_round": ("committed", "delivered", "snapshot_miss"),
            "orderstatus_round": ("result", "found"),
            "stocklevel_round": ("result",)}
TWINS = {"neworder_round_distributed": "neworder_round",
         "payment_round_distributed": "payment_round",
         "delivery_round_distributed": "delivery_round"}
# what a configuration may state beside PROGRAM_KEYS, and the values of
# the deployment that this harness and the reference implement: a file
# that states another (a compressed oracle, the journal, warehouse-major
# placement, locality routing) or a key unknown here is refused, so that
# no cell runs other guarantees than its file states
RUN_KEYS = ("memory_servers", "gc_interval", "max_txn_time", "gc_snapshots")
IMPLEMENTED = {"layout": ("table_major",), "journal": (False,),
               "routing": ("none",)}
ORACLE = {True: "vector", False: "partitioned_vector"}
DESCRIPTIVE = ("name", "source", "deployment", "reduced", "guarantees",
               "assumed", "pool")


class Spec(NamedTuple):
    root: Path
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    work: dict


def load(root: Path, workload: str) -> Spec:
    """The cell named ``workload`` and its files, from the checkout at
    ``root``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / cfgs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    work = json.loads(
        (root / "bench" / "cells" / f"{workload}.json").read_text())
    return Spec(root, bench, cell, config, traffic, work)


def run_config(config: dict, work: dict) -> dict:
    """The configuration as both sides run it, the extents holding the
    cell's whole draw horizon (a thread inserts at most one order and one
    history record a round). Refuses a configuration that states a key or
    a value the deployment does not implement."""
    known = PROGRAM_KEYS + RUN_KEYS + tuple(IMPLEMENTED) + ("oracle",) \
        + DESCRIPTIVE
    bad = [f"{k}={config[k]!r}" for k in config if k not in known]
    bad += [f"{k}={config.get(k)!r}" for k, ok in IMPLEMENTED.items()
            if config.get(k) not in ok]
    S = int(config["memory_servers"])
    if config.get("oracle") != ORACLE[S == 1]:
        bad.append(f"oracle={config.get('oracle')!r} with memory_servers="
                   f"{S} (the deployment runs {ORACLE[S == 1]!r})")
    if bad:
        raise ValueError("the configuration states what the benchmark does "
                         "not implement: " + ", ".join(bad))
    out = dict(config)
    out["orders_per_thread"] = int(work["horizon_rounds"])
    return out


def clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    return x


class Deployment:
    """The program loaded as the configuration deploys it: one memory
    server, or ``memory_servers`` of them as the sharded store on one
    card."""

    def __init__(self, prog, rcfg: dict, traffic: dict, load_seed: int,
                 device):
        tpcc, tso = prog.tpcc, prog.tsoracle
        self.prog, self.rcfg, self.traffic = prog, rcfg, traffic
        self.dev = torch.device(device)
        kw = {k: rcfg[k] for k in PROGRAM_KEYS}
        self.cfg = tpcc.TPCCConfig(orders_per_thread=rcfg["orders_per_thread"],
                                   **kw)
        T, S = self.cfg.n_threads, int(rcfg["memory_servers"])
        self.lay, self.st = tpcc.init_tpcc(
            self.cfg, tso.VectorOracle(T),
            torch.Generator(device=self.dev).manual_seed(load_seed),
            device=self.dev)
        self.engine = None
        if S == 1:
            self.oracle = tso.VectorOracle(T)
        else:
            self.oracle = tso.PartitionedVectorOracle(T, n_parts=S)
            make = tpcc.make_mixed_engine if traffic["driver"] == "mixed" \
                else tpcc.make_distributed_engine
            self.engine = make(self.cfg, self.lay, S, self.oracle,
                               shard_vector=True)
            self.st = tpcc.distribute_state(self.engine, self.st)
        self.R = self.lay.catalog.total_records

    def driver(self):
        tpcc = self.prog.tpcc
        fn = tpcc.run_mixed_rounds if self.traffic["driver"] == "mixed" \
            else tpcc.run_neworder_rounds
        kw = dict(gc_interval=int(self.rcfg["gc_interval"]),
                  max_txn_time=int(self.rcfg["max_txn_time"]),
                  gc_snapshots=int(self.rcfg["gc_snapshots"]))
        if self.traffic["driver"] == "mixed":
            kw["stock_last_n"] = int(self.traffic["stock_last_n"])
        return fn, kw

    def run(self, st, draw, n_rounds, engine=None):
        """One driver call of ``n_rounds`` rounds on ``st``: (state,
        stats)."""
        fn, kw = self.driver()
        eng = self.engine if engine is None else engine
        return fn(self.cfg, self.lay, st, self.oracle, draw, n_rounds,
                  engine=eng, device=self.dev, **kw)

    def outcome(self, st):
        """What the comparison reads of the program's final state: the
        current versions of the real records, the vector, the order index
        and the extents' cursors (references, no copies)."""
        nam = st.nam
        return {"cur_hdr": nam.table.cur_hdr[:self.R],
                "cur_data": nam.table.cur_data[:self.R],
                "vec": nam.oracle_state.vec[:self.cfg.n_threads],
                "idx_keys": st.order_index.delta_keys,
                "idx_vals": st.order_index.delta_vals,
                "idx_base": st.order_index.base_keys,
                "o_cursor": nam.extends.cursor[:, 0],
                "h_cursor": st.hist_cursor}


class Recorder:
    """While active, wraps the drivers' sub-round functions (and, given
    ``spans``, the store's executors, the version mover and the GC sweep):
    each sub-round call logs its outcome tensors by reference, under its
    single-server name; with ``spans`` every wrapped call runs inside a
    ``torch.profiler.record_function`` range named ``bench.<name>``."""

    def __init__(self, prog, spans: bool = False):
        self.prog, self.spans, self.log = prog, spans, []

    def _span(self, name):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    def _wrap_round(self, name, fn):
        single = TWINS.get(name, name)
        fields = OUTCOMES[single]

        def run(*a, **k):
            with self._span(single):
                out = fn(*a, **k)
            self.log.append((single, {f: getattr(out, f) for f in fields},
                             k.get("active")))
            return out
        return run

    def _wrap(self, name, fn):
        def run(*a, **k):
            with self._span(name):
                return fn(*a, **k)
        return run

    def engine(self, engine):
        """``engine`` with its executors inside spans (``store.<fn>``)."""
        if engine is None or not self.spans:
            return engine
        base = engine.base if hasattr(engine, "base") else engine
        base = base._replace(
            round_fn=self._wrap("store.round_fn", base.round_fn),
            gc_fn=self._wrap("store.gc_fn", base.gc_fn))
        if not hasattr(engine, "base"):
            return base
        return engine._replace(
            base=base,
            payment_fn=self._wrap("store.payment_fn", engine.payment_fn),
            delivery_fn=self._wrap("store.delivery_fn", engine.delivery_fn),
            readonly_fn=self._wrap("store.readonly_fn", engine.readonly_fn))

    def __enter__(self):
        tpcc, mvcc = self.prog.tpcc, self.prog.mvcc
        self.saved = []
        for name in list(OUTCOMES) + list(TWINS):
            self.saved.append((tpcc, name, getattr(tpcc, name)))
            setattr(tpcc, name, self._wrap_round(name, getattr(tpcc, name)))
        if self.spans:
            for mod, name, label in ((tpcc, "_gc_sweep", "gc_sweep"),
                                     (mvcc, "version_mover",
                                      "version_mover")):
                self.saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, self._wrap(label, getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
