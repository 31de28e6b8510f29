"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell,
one run.

    python3 bench/run.py --workload <name> --seed <n>
        --seconds <s> --trace <0|1>

runs the cell ``<name>`` of ``BENCHMARK.json`` on the card it starts on:
set-up (the program's load from the seed, the draw horizon, the kernels'
builds and a warm-up driver call), then the window, then the reference's
replay of every round and the comparison. The window runs a fixed amount
of work, the cell's ``window_rounds_per_second`` times ``--seconds``
rounds (``bench/cells/<name>.json`` says how long that took on the card
when the benchmark was defined), every round's start stamped, then the cell's ``trace_rounds`` more under
the profiler, whose device time the end-to-end ``device_us_per_txn``
reads. With ``--trace 0`` the result holds the cell's end-to-end metrics.
With ``--trace 1`` the same rounds run, the traced ones after they ran on
a copy of the state with the kernels' work counted, and the result holds
the per-layer metrics: those of the trace from the traced rounds, the
round times, rate and abort rate from the window's. The last line of standard output is the result's
JSON object; the numbers compared, each with its limit, are the last lines
of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def program(root: Path):
    """The program's modules (``repro_torch`` from the checkout's
    ``src``)."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import types

    from repro_torch.core import mvcc, tsoracle
    from repro_torch.db import tpcc, workload
    from repro_torch.kernels import _build
    from repro_torch.kernels.commit import ops as commit_ops
    from repro_torch.kernels.hash_probe import ops as probe_ops
    return types.SimpleNamespace(tpcc=tpcc, workload=workload, mvcc=mvcc,
                                 tsoracle=tsoracle, build=_build,
                                 probe_ops=probe_ops, commit_ops=commit_ops)


def reader(root: Path, name: str):
    """The metric ``name``'s reader, ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec, kind: str) -> list:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``)."""
    name = spec.cell["name"]
    return [m for m in spec.bench[kind]
            if name in m.get("workloads", [name])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _stamped(horizon, offset, stamps):
    """``draw(r)`` of a driver call whose round 0 is the horizon's round
    ``offset``; it stamps the host clock at the start of every round."""

    def draw(r):
        stamps.append(time.perf_counter())
        return horizon.draw(offset + r)
    return draw


def run_cell(spec, seed: int, seconds: float, trace: bool, device,
             *, prog=None, log=print) -> dict:
    """One run of the cell: ``correct``, ``attempted``, ``failed``, the
    numbers compared, what the metric readers read of the window
    (``window``) and the card's peak memory."""
    import torch

    from bench import cell as cellmod, check, gen, tracing, work
    from bench.reference import tpcc_ref

    cuda = torch.device(device).type == "cuda"
    prog = prog or program(spec.root)
    rcfg = cellmod.run_config(spec.config, spec.work)
    traffic, amounts = spec.traffic, spec.work
    H = int(amounts["horizon_rounds"])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    log(f"set-up: imports {t0 - T_START:.2f} s")
    if cuda and (rcfg["fused_commit"] or rcfg["batched_probe"]):
        prog.build.build_all(("batched_probe", "fused_commit"))
    dep = cellmod.Deployment(prog, rcfg, traffic, gen.load_seed(seed),
                             device)
    sync()
    t1 = time.perf_counter()
    horizon = gen.horizon(prog.workload, rcfg, traffic, seed, H, device)
    sync()
    t2 = time.perf_counter()
    log(f"set-up: kernels and load {t1 - t0:.2f} s ({dep.R} records), "
        f"{H} rounds drawn {t2 - t1:.2f} s")
    start_out = {k: v.clone() for k, v in dep.outcome(dep.st).items()
                 if k in ("o_cursor", "h_cursor")}
    n_warm = int(amounts["warmup_rounds"])
    n_win = max(1, round(float(amounts["window_rounds_per_second"])
                         * seconds))
    n_trace = int(amounts["trace_rounds"])
    if n_warm + n_win + n_trace > H:
        raise RuntimeError(
            f"the run needs {n_warm + n_win + n_trace} rounds, past the "
            f"draw horizon of {H}: the cell's horizon_rounds is too small")
    offsets = [0, n_warm, n_warm + n_win]

    # ---- warm-up: one driver call ----
    stamps = []
    with cellmod.Recorder(prog) as rec:
        sync()
        st, stats_w = dep.run(dep.st, _stamped(horizon, 0, stamps),
                              n_warm)
        sync()
        stamps.append(time.perf_counter())
    calls = [(check.program_stats(stats_w), check.program_log(rec.log))]
    log(f"set-up: warm-up {n_warm} rounds {stamps[-1] - stamps[0]:.2f} s; "
        f"window {n_win} rounds")

    # ---- the window: one driver call, every round's start stamped ----
    stamps = []
    with cellmod.Recorder(prog) as rec:
        sync()
        setup_s = time.perf_counter() - T_START
        st, stats = dep.run(st, _stamped(horizon, n_warm, stamps), n_win)
        sync()
        stamps.append(time.perf_counter())
    round_s = [b - a for a, b in zip(stamps, stamps[1:])]
    q = sorted(round_s)
    log(f"window: {stamps[-1] - stamps[0]:.3f} s, round median "
        f"{q[len(q) // 2] * 1e3:.3f} ms, first {round_s[0] * 1e3:.3f}, "
        f"first half {sum(round_s[:len(q) // 2]) * 1e3:.1f} ms, second "
        f"half {sum(round_s[len(q) // 2:]) * 1e3:.1f} ms")
    pstats = check.program_stats(stats)
    win = dict(rounds=n_win, seconds=stamps[-1] - stamps[0],
               setup_s=setup_s, stats=pstats, round_s=round_s)
    calls.append((pstats, check.program_log(rec.log)))
    if trace:
        # the traced rounds run twice from one state: first on a copy
        # with the kernels' work counted
        copy = cellmod.clone_tree(st)
        kw = work.KernelWork(prog.probe_ops, prog.commit_ops)
        with cellmod.Recorder(prog) as rec_c, kw:
            copy, stats_c = dep.run(
                copy, lambda r: horizon.draw(offsets[2] + r), n_trace)
        copy_out = {k: v.clone() for k, v in dep.outcome(copy).items()}
        copy_calls = (check.program_stats(stats_c),
                      check.program_log(rec_c.log))
        del copy
    # ---- the traced rounds, under the profiler ----
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with cellmod.Recorder(prog, spans=True) as rec:
        eng = rec.engine(dep.engine)

        def spanned(r):
            with torch.profiler.record_function("bench.draw"):
                return horizon.draw(offsets[2] + r)
        with profile(activities=acts) as prof:
            sync()
            with torch.profiler.record_function("bench.window"):
                st, stats_t = dep.run(st, spanned, n_trace, engine=eng)
                sync()
    t0 = time.perf_counter()
    summary = tracing.summarize(prof)
    del prof
    log(f"trace read in {time.perf_counter() - t0:.2f} s")
    calls.append((check.program_stats(stats_t), check.program_log(rec.log)))
    win.update(trace=summary, trace_rounds=n_trace,
               trace_stats=calls[-1][0])
    if trace:
        traced_out = dep.outcome(st)
        replay = check.decisions([copy_calls], [calls[-1]]) + sum(
            check.diff(v, traced_out[k]) for k, v in copy_out.items())
        win.update(work=kw.seconds, work_calls=kw.calls,
                   replay_mismatch=replay)
        del copy_out, traced_out
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    keep = dep.outcome(st)
    numbers = {"failed": check.failed(calls, start_out, keep)}
    attempted = sum(v for k, v in pstats.items() if k.startswith("attempts"))
    # ---- free the program's state; the reference replays every round ----
    del st, dep.st
    dep.engine = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = tpcc_ref.RefTPCC(rcfg, device).load(gen.load_seed(seed))
    drive = tpcc_ref.DRIVERS[traffic["driver"]]
    kw = dict(gc_interval=int(rcfg["gc_interval"]),
              max_txn_time=int(rcfg["max_txn_time"]),
              gc_snapshots=int(rcfg["gc_snapshots"]),
              stock_last_n=int(traffic.get("stock_last_n", 8)))
    ref_calls = [drive(ref, lambda r, o=o: horizon.draw(o + r), n, **kw)
                 for o, n in zip(offsets, (n_warm, n_win, n_trace)) if n]
    numbers["decisions"] = check.decisions(calls, ref_calls)
    numbers.update(check.state(keep, ref))
    if trace:
        numbers["decisions"] += win["replay_mismatch"]
    log(f"reference: {n_warm + n_win + n_trace} rounds in "
        f"{time.perf_counter() - t0:.2f} s")
    del ref, keep
    return dict(correct=check.verdict(numbers), attempted=attempted,
                failed=numbers["failed"], numbers=numbers, window=win,
                memory_peak_bytes=peak)


def pin_cores():
    """Keep the run on the last two of the cores it may use: the rounds
    are paced by this process's Python, whose speed varies with the cores
    the scheduler moves it over (a setting of this process alone)."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 2:
        os.sched_setaffinity(0, cores[-2:])


def main(argv=None, *, root: Path = ROOT, device=None) -> int:
    args = parse(argv)
    if device is None:
        pin_cores()
    from bench import cell as cellmod
    spec = cellmod.load(root, args.workload)
    import torch
    torch.set_num_threads(2)
    if device is None:
        need = int(spec.cell["chips"])
        have = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if have < need:
            print(f"bench: the cell needs {need} CUDA card(s); {have} "
                  f"available", file=sys.stderr)
            return 2
        device = "cuda"
        build = root / "build"
        os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
        os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    res = run_cell(spec, args.seed, args.seconds, bool(args.trace), device,
                   log=lambda m: print(m, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process loaded {bad}", file=sys.stderr)
        return 3
    ctx = dict(res["window"], config=spec.config, traffic=spec.traffic,
               cell=spec.cell)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, kind):
        v = reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        tr = res["window"]["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        from bench import tracing
        out["breakdown"] = tracing.breakdown(tr)
    from bench import check
    out["checks"] = {k: {"value": res["numbers"][k], "limit": lim}
                     for k, lim in check.LIMITS.items()}
    for line in check.lines(res["numbers"]):
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
