"""TPC-C on the PyTorch port's NAM core (the counterpart of
``examples/tpcc_demo.py``): the paper's headline experiment in miniature.

Loads a small TPC-C database into the NAM store, runs the **full
five-transaction mix** (45/43/4/4/4) through the SI protocol
(timestamp-vector oracle, combined validate+lock CAS, multi-versioning,
per-type §7.4 retry queues), measures the real abort rate and per-type
RDMA-op profiles, and feeds them into the calibrated network model to
project cluster throughput at 8, 28 and 56 machines — **both total and
new-order** txn/s, the paper's Fig. 4 split (6.5M new-order of 14.5M
total). It runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/tpcc_demo_torch.py --rounds 8 --skew 0.9
    PYTHONPATH=src python examples/tpcc_demo_torch.py --device cpu

With ``--shards 8`` the rounds run over 8 memory servers, held on one
device as a leading shard axis (``tpcc.make_mixed_engine``), in both
Fig. 5 locality deployments.

The pool is loaded on the CPU from ``--seed`` and the draws come from a
CPU generator seeded ``--seed + 1``, both then moved to the device: one
seed gives the same run on the card and on the CPU.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import _tree  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import locality, netmodel  # noqa: E402
from repro_torch.core.tsoracle import PartitionedVectorOracle  # noqa: E402
from repro_torch.core.tsoracle import VectorOracle  # noqa: E402
from repro_torch.db import tpcc, workload  # noqa: E402
from repro_torch.db.tpcc import mixed_profiles, neworder_share  # noqa: E402

# the two Fig. 5 deployments: (locality mode, layout)
MODES = (("aware", "warehouse_major"), ("oblivious", "table_major"))


def mix_line(stats: tpcc.MixedRunStats) -> str:
    per_type = "  ".join(
        f"{t}:{stats.commits[t]}/{stats.attempts[t]}"
        for t in workload.TXN_TYPES)
    return f"  commits/attempts per type: {per_type}"


def single_config(args) -> tpcc.TPCCConfig:
    return tpcc.TPCCConfig(n_warehouses=args.warehouses,
                           customers_per_district=32, n_items=256,
                           n_threads=args.threads, orders_per_thread=64,
                           dist_degree=args.dist, skew_alpha=args.skew)


def sharded_config(args, layout: str) -> tpcc.TPCCConfig:
    """The sharded path pins one execution thread per warehouse (the
    paper's terminal density): ``--warehouses`` is ``--threads``."""
    return tpcc.TPCCConfig(
        n_warehouses=args.threads, customers_per_district=16,
        n_items=256, n_threads=args.threads,
        orders_per_thread=max(64, args.rounds * 2),
        dist_degree=args.dist, skew_alpha=args.skew, layout=layout)


def to_device(tree, device):
    """A tree of tensors (a state, a round's draws) on ``device``."""
    return _tree.tmap(lambda t: t.to(device)
                      if isinstance(t, torch.Tensor) else t, tree)


def load(cfg: tpcc.TPCCConfig, oracle, seed: int, device):
    """``init_tpcc`` on the CPU from ``seed``, the state moved to
    ``device``: the same pool whatever the device."""
    lay, st = tpcc.init_tpcc(cfg, oracle, torch.Generator().manual_seed(seed),
                             device="cpu")
    return lay, to_device(st, device)


def draws(cfg: tpcc.TPCCConfig, seed: int, device, home_w=None):
    """``workload.mixed_stream`` on a CPU generator from ``seed``, each
    round moved to ``device``."""
    draw = workload.mixed_stream(cfg, torch.Generator().manual_seed(seed),
                                 home_w=home_w)
    return lambda r: to_device(draw(r), device)


def run_single(cfg, lay, st, oracle, draw, n_rounds: int, device):
    """``n_rounds`` full-mix rounds on one memory server, and the cluster
    projection from them. Returns ``(stats, printed lines)``."""
    t0 = time.time()
    st, stats = tpcc.run_mixed_rounds(cfg, lay, st, oracle, draw, n_rounds,
                                      device=device)
    dt = time.time() - t0
    lines = [
        f"ran {stats.total_attempts} transactions ({n_rounds} rounds x "
        f"{cfg.n_threads} threads, full 45/43/4/4/4 mix) in {dt:.1f}s",
        f"abort rate = {stats.abort_rate:.3f}  (skew={cfg.skew_alpha}, "
        f"dist={cfg.dist_degree}%)",
        mix_line(stats)]
    per_type, prof = mixed_profiles(stats)
    share = neworder_share(stats)
    lines += [f"mix profile: reads={prof.reads:.1f} cas={prof.cas:.1f} "
              f"installs={prof.installs:.1f}  (new-order: "
              f"reads={per_type['neworder'].reads:.1f} "
              f"cas={per_type['neworder'].cas:.1f})",
              "", "projected cluster throughput (calibrated cost model, "
                  "Fig. 4):"]
    for n in (8, 28, 56):
        thr = netmodel.namdb_throughput(prof, n, 60, stats.abort_rate)
        thr_loc = netmodel.namdb_throughput(prof, n, 60, stats.abort_rate,
                                            local_fraction=0.9)
        trad = netmodel.traditional_throughput(prof, n, 60, stats.abort_rate)
        lines.append(f"  {n:3d} machines: NAM-DB total {thr / 1e6:5.2f} M "
                     f"txn/s (new-order {thr * share / 1e6:5.2f} M)"
                     f"   +locality {thr_loc / 1e6:5.2f} M   traditional "
                     f"{trad / 1e3:6.0f} k")
    lines += ["", "(paper anchors @56: 14.5 M total / 6.5 M new-order w/ "
                  "locality; 3.64 M w/o)"]
    return stats, lines


def run_sharded(cfg, lay, st, n_shards: int, draw, n_rounds: int,
                mode: str, device):
    """``n_rounds`` full-mix rounds over ``n_shards`` memory servers (one
    device, a leading shard axis, the vector partitioned) in the locality
    deployment ``mode``; ``st`` is the loaded single-server state. The
    projection counts ``2 · n_shards`` machines. Returns ``(stats,
    printed lines)``."""
    oracle = PartitionedVectorOracle(cfg.n_threads, n_parts=n_shards)
    engine = tpcc.make_mixed_engine(cfg, lay, n_shards, oracle,
                                    shard_vector=True)
    st = tpcc.distribute_state(engine, st)
    home = locality.thread_homes(cfg.n_threads, cfg.n_warehouses)
    st, stats = tpcc.run_mixed_rounds(
        cfg, lay, st, oracle, draw, n_rounds, home_w=home, engine=engine,
        locality_mode=mode, device=device)
    _, prof = mixed_profiles(stats)
    total = netmodel.namdb_throughput(prof, 2 * n_shards, 60,
                                      stats.abort_rate,
                                      local_fraction=stats.local_fraction)
    return stats, [
        f"{n_shards}-server mesh, {mode:9s}: "
        f"{stats.total_commits}/{stats.total_attempts} committed "
        f"(steady-state abort {stats.abort_rate:.3f}), "
        f"{stats.local_fraction * 100:.0f}% of accesses machine-local, "
        f"total {total / 1e6:.2f}M txn/s "
        f"(new-order {total * neworder_share(stats) / 1e6:.2f}M)",
        mix_line(stats)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--warehouses", type=int, default=16)
    ap.add_argument("--skew", type=float, default=None,
                    help="zipf alpha (None = uniform)")
    ap.add_argument("--dist", type=float, default=10.0,
                    help="%% of new-orders touching a remote warehouse")
    ap.add_argument("--shards", type=int, default=1,
                    help="run over this many memory servers (a leading "
                         "shard axis on the device)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="the pool's seed; the draws take seed + 1")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)

    if args.shards > 1:
        if args.warehouses != args.threads:
            print(f"# note: --shards pins warehouses to --threads "
                  f"({args.threads}); ignoring --warehouses="
                  f"{args.warehouses}")
        for mode, layout in MODES:
            cfg = sharded_config(args, layout)
            lay, st = load(cfg, PartitionedVectorOracle(
                cfg.n_threads, n_parts=args.shards), args.seed, dev)
            home = locality.thread_homes(cfg.n_threads, cfg.n_warehouses)
            _, lines = run_sharded(cfg, lay, st, args.shards,
                                   draws(cfg, args.seed + 1, dev, home),
                                   args.rounds, mode, dev)
            print("\n".join(lines))
    else:
        cfg = single_config(args)
        oracle = VectorOracle(cfg.n_threads)
        lay, st = load(cfg, oracle, args.seed, dev)
        _, lines = run_single(cfg, lay, st, oracle,
                              draws(cfg, args.seed + 1, dev), args.rounds,
                              dev)
        print("\n".join(lines))
    print("tpcc_demo OK")


if __name__ == "__main__":
    main()
