#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--rounds 32] [--seed 0] [--profile-rounds 4]

Phases, each fatal on failure:

1. build both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each,
   started together);
2. load TPC-C at one NAM-DB memory server's scale (50 warehouses, 100,000
   items, 3,000 customers per district, 60 threads) on the card;
3. run each kernel and its plain version on clones of one real round's
   inputs and of a constructed adversarial case: outputs and state planes
   must be bit-identical;
4. run ``--rounds`` new-order rounds through the kernels (key-addressed,
   ``batched_probe`` and ``fused_commit`` on) and the same inputs from a
   cloned start state through the plain path: per-round outcomes and the
   final state must be identical, both kernels must have launched on the
   main path, and some transactions must commit;
5. time the rounds, each kernel (CUDA events) beside its bound and its
   plain version, and profile a few rounds for the device breakdown.

It prints the card, the kernels' JSON line, and as its last line
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch._u32 import u64  # noqa: E402
from repro_torch.core import hashtable as ht  # noqa: E402
from repro_torch.core.tsoracle import VectorOracle  # noqa: E402
from repro_torch.db import tpcc, workload  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.commit import ops as commit_ops  # noqa: E402
from repro_torch.kernels.commit import ref as commit_ref  # noqa: E402
from repro_torch.kernels.hash_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.hash_probe import ref as probe_ref  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the FP32 rate
# outside the tensor cores, taken as the rate of 32-bit integer work
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
OPS_PER_WORD = 10   # integer operations counted per 32-bit word loaded

SLICE = tpcc.TPCCConfig(
    n_warehouses=50, customers_per_district=3000, n_items=100_000,
    n_threads=60, orders_per_thread=128, dist_degree=10.0,
    n_old_versions=2, n_overflow=2, layout="table_major",
    key_addressed=True, fused_commit=True, batched_probe=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------ trees ----
def tmap(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [tmap(fn, y) for y in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in leaves(y)]
    return []


def clone(x):
    return tmap(lambda t: t.clone(), x)


def max_abs_err(a, b):
    """Largest |a - b| over paired integer/bool leaves; raises on a shape
    mismatch."""
    la, lb = leaves(a), leaves(b)
    check(len(la) == len(lb), f"leaf count {len(la)} != {len(lb)}")
    err = 0
    for x, y in zip(la, lb):
        check(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def same(a, b, what):
    err = max_abs_err(a, b)
    check(err == 0, f"{what}: kernel and plain version differ "
                    f"(max |diff| {err})")
    return err


# ----------------------------------------------------------- timing ----
HOLD_CYCLES = 50_000_000   # ~25 ms of GPU clock: longer than enqueueing


def time_events(fn, n, before=None, hold=False):
    """Mean ms of ``fn`` over ``n`` calls, each between a pair of CUDA
    events; ``before`` runs outside the timed pair. With ``hold`` the GPU
    first spins while every call is enqueued, so each pair brackets device
    work alone and not the host's launch overhead (``fn`` must not
    synchronise)."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    for i in range(n):
        if before is not None:
            before()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / n


def time_host(fn, n, before=None):
    """Mean ms per call on the host clock, the device synchronised after
    every call: what a caller waits for one launch."""
    total = 0.0
    for _ in range(n):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / n * 1e3


def bound(n_bytes, n_words):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_words * OPS_PER_WORD / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------- work of a call ----
def probe_work(args, kw, out):
    """Bytes the batched probe must move on these inputs: each lane's
    inputs and outputs, the directory words its probe chain reads, and the
    headers and ring counters its resolution examines; ts_vec once."""
    dk, dv, table, ts, fb, keys, km = args
    slot, found, src, pos = out
    Q = fb.shape[0]
    n_bytes = Q * (4 + 13) + ts.shape[0] * 4
    words = 0
    if dk is not None:
        n_bytes += Q * 5
        key1 = (u64(keys) + 1) & 0xFFFFFFFF
        base = ht._hash(keys, dk.shape[0])
        steps = torch.zeros(Q, dtype=torch.int64, device=fb.device)
        hit = torch.zeros(Q, dtype=torch.bool, device=fb.device)
        done = ~km
        for p in range(kw.get("max_probes", 16)):
            k = u64(dk[(base + p) % dk.shape[0]])
            steps += (~done).long()
            hit |= ~done & (k == key1)
            done = done | (k == key1) | (k == 0)
        n_probe = int(steps.sum())
        n_bytes += n_probe * 4 + int(hit.sum()) * 4
        words += n_probe
    K, KO = table.n_old, table.ovf_hdr.shape[1]
    s = torch.where(slot >= 0, slot, 0).long().clamp(0, table.n_records - 1)
    nw = table.next_write[s].long()
    on = table.ovf_next[s].long()
    old_seen = torch.where(src == 0, 0, torch.where(
        src == 1, torch.remainder(nw - 1 - pos, K) + 1, K))
    ovf_seen = torch.where(src == 2, torch.where(
        found, torch.remainder(on - 1 - pos, KO) + 1, KO), 0)
    headers = Q + int(old_seen.sum()) + int(ovf_seen.sum())
    counters = int((src != 0).sum()) + int((src == 2).sum())
    n_bytes += headers * 8 + counters * 4
    words += 2 * headers + counters
    # random loads, one 32-byte sector each: probes, values, headers, ring
    # counters and a ts_vec word per header
    dir_loads = n_probe + int(hit.sum()) if dk is not None else 0
    sectors = dir_loads + 2 * headers + counters
    return n_bytes, words, sectors


def commit_work(args, out):
    """Bytes the fused commit must move on these inputs: the request and
    transaction inputs, the header, counter and ring victim of every active
    request, the installs it writes, the vector slots and the outputs."""
    (table, vec, slots, exp, prio, act, txn, new_hdr, new_data, txn_ok,
     txn_slot, cts, ext) = args
    Q, T = slots.shape[0], txn_ok.shape[0]
    n_act = int(act.sum())
    n_inst = int(out.do_install.sum())
    n_bytes = Q * 29 + T * 13 + n_act * 20 + n_inst * 20 + T * 8 \
        + Q * 2 + T * 5
    words = Q * 7 + n_act * 5 + n_inst * 5 + T * 5
    # random accesses, one 32-byte sector each: header, counter and ring
    # victim per active request, three writes per install, a vector slot
    # per transaction
    sectors = 3 * n_act + 3 * n_inst + T
    return n_bytes, words, sectors


def timed_run(cfg, lay, st, oracle, stream, n_rounds):
    """``run_neworder_rounds`` with each round's host time: it calls
    ``draw`` once at the start of every round and synchronises on the
    round's outcome before the next, so the gaps between draws are rounds."""
    stamps = []

    def draw(r):
        stamps.append(time.perf_counter())
        return stream(r)

    torch.cuda.synchronize()
    st, stats = tpcc.run_neworder_rounds(cfg, lay, st, oracle, draw,
                                         n_rounds, device="cuda")
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    return st, stats, [b - a for a, b in zip(stamps, stamps[1:])]


# ---------------------------------------------------------- capture ----
def capture_round(cfg, lay, st, oracle, stream, n_rounds):
    """Run ``n_rounds`` rounds on ``st`` and keep clones of the last
    round's kernel inputs."""
    cap = {}
    orig = probe_ops.batched_probe, commit_ops.fused_commit

    def grab(name, fn):
        def wrapped(*a, **k):
            cap[name] = (clone(a), dict(k))
            return fn(*a, **k)
        return wrapped

    probe_ops.batched_probe = grab("probe", orig[0])
    commit_ops.fused_commit = grab("commit", orig[1])
    try:
        tpcc.run_neworder_rounds(cfg, lay, st, oracle, stream, n_rounds,
                                 device=st.nam.table.cur_hdr.device)
    finally:
        probe_ops.batched_probe, commit_ops.fused_commit = orig
    return cap["probe"], cap["commit"]


def adversarial_probe(args):
    """The real round's lanes made hostile: absent keys, a key whose +1
    wraps to the empty marker, invalidated directory entries, slot lanes
    out of range, and a halved snapshot that hides recent versions."""
    dk, dv, table, ts, fb, keys, km = clone(args)
    Q = fb.shape[0]
    lane = torch.arange(Q, device=fb.device)
    keys[lane % 10 == 3] = 0x5EADBEEF
    keys[5] = -1
    hit = torch.isin(u64(dk), (u64(keys[km][::7]) + 1) & 0xFFFFFFFF)
    dv[hit] = -1
    fb[(lane % 17 == 4) & ~km] = -3
    fb[(lane % 19 == 6) & ~km] = table.n_records + 5
    ts.copy_((u64(ts) // 2).to(torch.int32))
    return dk, dv, table, ts, fb, keys, km


def adversarial_commit(args):
    """The real round's requests made hostile, sparsely enough that some
    transactions still commit: hot duplicate slots across transactions,
    stale expectations, locked targets, immovable ring victims, padding
    lanes with garbage ids, remote failures and gated-off transactions."""
    (table, vec, slots, exp, prio, act, txn, new_hdr, new_data, txn_ok,
     txn_slot, cts, ext) = clone(args)
    Q, T = slots.shape[0], txn_ok.shape[0]
    WS = Q // T
    lane = torch.arange(Q, device=slots.device)
    hot = (lane % WS == 1) & (txn % 3 == 1) & act
    hot_slot = int(slots[0])
    slots[hot] = hot_slot
    exp[hot] = table.cur_hdr[hot_slot]
    exp[(lane % 97 == 2) & act, 1] += 1
    lk = (lane % 89 == 5) & act
    locked = slots[lk].long()
    table.cur_hdr[locked, 0] |= 1
    exp[lk] = table.cur_hdr[locked]
    victim = slots[(lane % WS == 2) & act & (txn % 7 == 3)].long()
    wpos = torch.remainder(table.next_write[victim].long(), table.n_old)
    table.old_hdr[victim, wpos, 0] &= ~4
    pad = (lane % 13 == 0) & (lane % WS != 0)
    act[pad] = False
    txn[pad] = 10 ** 6
    slots[pad] = -7
    ext[1::4] = 1
    txn_ok[2::9] = False
    return (table, vec, slots, exp, prio, act, txn, new_hdr, new_data,
            txn_ok, txn_slot, cts, ext)


def commit_lattice(args, out):
    """Outcome counts of one commit: committed and aborted transactions,
    denied requests and granted requests of aborted transactions."""
    act, txn = args[5], args[6].long().clamp(0, args[9].shape[0] - 1)
    c, g = out.committed, out.granted
    return dict(committed=int(c.sum()), aborted=int((~c).sum()),
                denied=int((act & ~g).sum()),
                released=int((g & ~c[txn]).sum()),
                installed=int(out.do_install.sum()))


def flat_commit(out):
    return tuple(out.table) + tuple(out[1:])


def time_kernels(p_args, p_kw, c_args, launches, report, n_time=200):
    """Each kernel's time (CUDA events over ``n_time`` launches on the same
    buffers), its plain version's time and its bound, at one real round's
    shapes; returns the kernels' JSON records."""
    launch = probe_ops.prepare(*p_args, **p_kw)
    for _ in range(10):
        launch()
    probe_ms = time_events(launch, n_time, hold=True)
    probe_host_ms = time_host(launch, 50)
    probe_plain_ms = time_events(
        lambda: probe_ref.batched_probe_ref(*p_args, **p_kw), 20)
    probe_work_ = probe_work(
        p_args, p_kw, probe_ref.batched_probe_ref(*p_args, **p_kw))

    base = clone(c_args)
    table = base[0]
    touched = torch.where(base[5], base[2], 0).long()
    saved = [t[touched].clone() for t in table[:5]] + [base[1].clone()]

    def restore():
        for t, s in zip(table[:5], saved[:5]):
            t.index_copy_(0, touched, s)
        base[1].copy_(saved[5])

    commit_launch = commit_ops.prepare(*base[:8], *base[9:])
    restore()
    for _ in range(10):
        commit_launch()
        restore()
    # restore() is six small launches per call: fewer calls keep the queue
    # short enough to be filled while the GPU is held
    commit_ms = time_events(commit_launch, max(1, n_time // 4),
                            before=restore, hold=True)
    commit_host_ms = time_host(commit_launch, 50, before=restore)
    commit_plain_ms = time_events(
        lambda: commit_ref.fused_commit_ref(*base), 20, before=restore)
    restore()
    commit_work_ = commit_work(
        base, commit_ref.fused_commit_ref(*clone(base)))
    torch.cuda.synchronize()

    kernels = []
    for name, src, replaces, ms, host_ms, plain_ms, (nb, nw, ns) in (
            ("batched_probe", "src/repro_torch/csrc/batched_probe.cu",
             "src/repro/kernels/hash_probe/kernel.py:231", probe_ms,
             probe_host_ms, probe_plain_ms, probe_work_),
            ("fused_commit", "src/repro_torch/csrc/fused_commit.cu",
             "src/repro/kernels/commit/kernel.py:126", commit_ms,
             commit_host_ms, commit_plain_ms, commit_work_)):
        bound_ms, bound_by = bound(nb, nw)
        sector_ms = ns * 32 / HBM_BYTES_PER_S * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=report[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, match=report[name] == 0, bytes=nb,
            random_sectors=ns, sector_bound_ms=sector_ms, host_ms=host_ms))
        print(f"{name}: {ms * 1e3:.2f} us/launch on the device (CUDA "
              f"events, GPU held while queued), {host_ms * 1e3:.2f} us per "
              f"synchronised call on the host clock, plain "
              f"{plain_ms * 1e3:.1f} us, bound "
              f"{bound_ms * 1e3:.4f} us ({bound_by}, {nb} B); "
              f"{ns} random 32-byte sectors: {sector_ms * 1e3:.4f} us")

    return kernels


# --------------------------------------------------------- profiling ----
def profile_rounds(cfg, lay, st, oracle, stream, n_rounds):
    """Device time by kernel over ``n_rounds`` rounds and the idle share:
    the device-side events of the trace (kernels, copies, fills), which run
    one at a time on the one stream, summed by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tpcc.run_neworder_rounds(cfg, lay, st, oracle, stream, n_rounds,
                                 device="cuda")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    rows = sorted(((k, t, n) for k, (t, n) in by_name.items()),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    return wall_us, busy_us, rows


# -------------------------------------------------------------- main ----
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-rounds", type=int, default=4)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 2. load ----------------------------------------------------------
    cfg = SLICE
    plain_cfg = dataclasses.replace(cfg, fused_commit=False,
                                    batched_probe=False)
    oracle = VectorOracle(cfg.n_threads)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lay, st = tpcc.init_tpcc(
        cfg, oracle, torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    torch.cuda.synchronize()
    R = lay.catalog.total_records
    pool_bytes = sum(t.numel() * t.element_size() for t in st.nam.table)
    print(f"load: {time.perf_counter() - t0:.2f} s, R={R} records, "
          f"pool {pool_bytes / 1e9:.3f} GB, directory "
          f"{st.directory.n_buckets} buckets, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)

    def stream(seed):
        return workload.neworder_stream(
            cfg, torch.Generator(device=dev).manual_seed(seed))

    # ---- 3. kernels against their plain versions ---------------------------
    (p_args, p_kw), (c_args, c_kw) = capture_round(
        cfg, lay, clone(st), oracle, stream(args.seed + 100), 4)
    report = {}
    for label, pa in (("real", p_args), ("adversarial",
                                         adversarial_probe(p_args))):
        ker = probe_ops.batched_probe(*pa, **p_kw)
        plain = probe_ref.batched_probe_ref(*pa, **p_kw)
        torch.cuda.synchronize()
        err = same(ker, plain, f"batched_probe ({label})")
        print(f"batched_probe {label}: Q={pa[4].shape[0]} found "
              f"{int(ker[1].sum())} src0/1/2 "
              f"{[int((ker[2] == s).sum()) for s in range(3)]} slot<0 "
              f"{int((ker[0] < 0).sum())}: bit-identical")
        report.setdefault("batched_probe", 0)
        report["batched_probe"] = max(report["batched_probe"], err)
    for label, ca in (("real", c_args), ("adversarial",
                                         adversarial_commit(c_args))):
        ker = commit_ops.fused_commit(*clone(ca))
        plain = commit_ref.fused_commit_ref(*clone(ca))
        torch.cuda.synchronize()
        err = same(flat_commit(ker), flat_commit(plain),
                   f"fused_commit ({label})")
        lat = commit_lattice(ca, ker)
        print(f"fused_commit {label}: Q={ca[2].shape[0]} active "
              f"{int(ca[5].sum())} {lat}: bit-identical")
        if label == "adversarial":
            check(all(lat.values()), f"adversarial commit case does not "
                                     f"reach every outcome: {lat}")
        report["fused_commit"] = max(report.get("fused_commit", 0), err)

    # ---- 4. end to end: kernels vs the plain path ---------------------------
    st_plain = clone(st)
    probe_ops.batched_probe.launches = 0
    commit_ops.fused_commit.launches = 0
    st_k, stats_k, rounds_k = timed_run(cfg, lay, st, oracle,
                                        stream(args.seed + 1), args.rounds)
    launches = {"batched_probe": probe_ops.batched_probe.launches,
                "fused_commit": commit_ops.fused_commit.launches}
    st_p, stats_p, rounds_p = timed_run(plain_cfg, lay, st_plain, oracle,
                                        stream(args.seed + 1), args.rounds)
    wall_k, wall_p = sum(rounds_k), sum(rounds_p)
    check(all(n > 0 for n in launches.values()),
          f"a kernel did not launch on the main path: {launches}")
    check(stats_k.commits > 0, "no transaction committed")
    same(stats_k.committed, stats_p.committed, "per-round commits")
    same(stats_k.missed, stats_p.missed, "per-round snapshot misses")
    same(st_k, st_p, "final state")
    check(tuple(stats_k.ops) == tuple(stats_p.ops)
          and stats_k[1:5] == stats_p[1:5], "run statistics differ")
    print(f"end to end: {args.rounds} rounds, launches {launches}, commits "
          f"{stats_k.commits}/{stats_k.attempts} (abort rate "
          f"{stats_k.abort_rate:.4f}, snapshot misses "
          f"{stats_k.snapshot_misses}); kernels and plain path identical")
    for label, rounds, stats in (("kernels", rounds_k, stats_k),
                                 ("plain", rounds_p, stats_p)):
        q = torch.tensor(rounds[1:] or rounds, dtype=torch.float64) * 1e3
        print(f"round time, {label}: first {rounds[0] * 1e3:.3f} ms, then "
              f"median {q.median():.3f} ms, min {q.min():.3f}, max "
              f"{q.max():.3f} over {len(q)} rounds (host clock); "
              f"{stats.commits / sum(rounds):.1f} committed new-orders/s")

    # ---- 5. timings ---------------------------------------------------------
    kernels = time_kernels(p_args, p_kw, c_args, launches, report)

    # ---- breakdown of a few more rounds (device time by kernel) -------------
    if args.profile_rounds:
        wall_us, busy_us, rows = profile_rounds(
            cfg, lay, st_k, oracle, stream(args.seed + 2), args.profile_rounds)
        print(f"profile: {args.profile_rounds} rounds, wall "
              f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
              f"(idle share {1 - busy_us / wall_us:.3f})")
        ours = ("batched_probe_kernel", "reset_kernel", "bid_kernel",
                "grant_kernel", "apply_kernel")
        shown = rows[:14] + [r for r in rows[14:]
                             if any(k in r[0] for k in ours)]
        for key, t_us, count in shown:
            print(f"  {t_us / 1e3:9.3f} ms  {count:6d}x  {key[:70]}")

    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
