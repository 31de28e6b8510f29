"""The control of the comparison: the reference with one stated guarantee
broken, put in the program's place, must come out not correct.

The configurations state no precision; the guarantee broken is "a
write-write conflict never commits twice": the control grants every write
(``RefTPCC(grant_all=True)``), so two transactions that write one record in
a sub-round both commit and one update is lost. Its decisions and final
state are held against the honest reference's with the run's comparison
(``bench/check.py``), on the same inputs and the same rounds.

    python3 bench/control.py --workload <name> --seeds 1,2,3 --rounds <n>

runs it at the cell's own size on the card (``--device cpu`` elsewhere)
for each seed over ``n`` rounds after the cell's warm-up rounds, and
prints each number beside its limit and whether the control came out
correct.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def outcome(db) -> dict:
    """A reference database's final state in the form
    ``check.state`` reads of the program."""
    keys = torch.where(db.idx_keys == (1 << 32) - 1, -1, db.idx_keys)
    return {"cur_hdr": torch.stack([db.cur_meta, db.cur_cts], dim=1),
            "cur_data": db.cur_data, "vec": db.vec, "idx_keys": keys,
            "idx_vals": db.idx_vals,
            "idx_base": torch.full((1,), -1, device=db.dev),
            "o_cursor": db.o_cursor, "h_cursor": db.h_cursor}


def run(spec, seed: int, n_window: int, device, wl) -> dict:
    """The control against the reference on ``seed``: the numbers
    compared (``check.LIMITS``' names but ``failed``)."""
    from bench import cell as cellmod, check, gen
    from bench.reference import tpcc_ref
    rcfg = cellmod.run_config(spec.config, spec.work)
    tr = spec.traffic
    n_warm = int(spec.work["warmup_rounds"])
    horizon = gen.horizon(wl, rcfg, tr, seed, n_warm + n_window, device)
    drive = tpcc_ref.DRIVERS[tr["driver"]]
    kw = dict(gc_interval=int(rcfg["gc_interval"]),
              max_txn_time=int(rcfg["max_txn_time"]),
              gc_snapshots=int(rcfg["gc_snapshots"]),
              stock_last_n=int(tr.get("stock_last_n", 8)))

    def replay(db):
        return [drive(db, lambda r: horizon.draw(r), n_warm, **kw),
                drive(db, lambda r: horizon.draw(n_warm + r), n_window, **kw)]

    ctl = tpcc_ref.RefTPCC(rcfg, device, grant_all=True).load(
        gen.load_seed(seed))
    ctl_calls = replay(ctl)
    ctl_out = {k: v.clone() for k, v in outcome(ctl).items()}
    del ctl
    ref = tpcc_ref.RefTPCC(rcfg, device).load(gen.load_seed(seed))
    ref_calls = replay(ref)
    numbers = {"decisions": check.decisions(ctl_calls, ref_calls)}
    numbers.update(check.state(ctl_out, ref))
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--rounds", type=int, required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from bench import cell as cellmod, check
    from repro_torch.db import workload
    spec = cellmod.load(ROOT, a.workload)
    for s in a.seeds.split(","):
        t0 = time.perf_counter()
        nums = run(spec, int(s), a.rounds, a.device, workload)
        ok = all(nums[k] <= check.LIMITS[k] for k in nums)
        print(json.dumps({"workload": a.workload, "seed": int(s),
                          "rounds": a.rounds, "control_correct": ok,
                          "numbers": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
