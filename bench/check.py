"""The comparison that decides ``correct``: the program's decisions and
final state against the reference's, every number held to its limit.

Numbers compared (each an exact count, limit 0):

* ``decisions``: statistics fields and sub-round outcome elements that
  differ: per type attempts, commits, retries, snapshot misses and
  contention aborts, deliveries and GC sweeps of each driver call; and in
  every sub-round the committed and snapshot-miss masks, deliveries, the
  new-order's order ids (committed lanes), the order-status's found mask
  and order rows (found lanes) and the stock-level's counts (active lanes);
* ``rows``: records whose current version (header and payload) differs;
* ``vector``: timestamp-vector slots that differ;
* ``index``: order-index entries that differ;
* ``cursors``: insert-extent cursors that differ;
* ``failed``: new-orders and payments that committed without their insert
  (an extent filled up).
"""
from __future__ import annotations

import torch

LIMITS = {"decisions": 0, "rows": 0, "vector": 0, "index": 0,
          "cursors": 0, "failed": 0}
TYPES = ("neworder", "payment", "orderstatus", "delivery", "stocklevel")
SENTINEL32 = -1


def program_stats(stats) -> dict:
    """A driver's statistics as the flat dict the reference returns."""
    if hasattr(stats, "total_attempts"):            # the mix
        out = {"delivered": stats.delivered, "gc_sweeps": stats.gc_sweeps}
        for n in TYPES:
            out[f"attempts.{n}"] = stats.attempts[n]
            out[f"commits.{n}"] = stats.commits[n]
            out[f"retries.{n}"] = stats.retries[n]
            out[f"snapshot_misses.{n}"] = stats.snapshot_misses[n]
            out[f"contention_aborts.{n}"] = stats.contention_aborts[n]
        return out
    return {"attempts": stats.attempts, "commits": stats.commits,
            "retries": stats.retries,
            "snapshot_misses": stats.snapshot_misses,
            "contention_aborts": stats.contention_aborts,
            "gc_sweeps": stats.gc_sweeps, "committed": stats.committed,
            "missed": stats.missed}


def program_log(log) -> list:
    """The recorder's sub-round log with the reference's field names and
    masks: lanes that carry no answer are zeroed."""
    out = []
    for name, f, active in log:
        short = name[:-len("_round")]
        if short == "neworder":
            g = {"committed": f["committed"],
                 "snapshot_miss": f["snapshot_miss"],
                 "o_id": torch.where(f["committed"], f["o_id"], 0)}
        elif short in ("payment", "delivery"):
            g = dict(f)
        elif short == "orderstatus":
            g = {"found": f["found"],
                 "result": torch.where(f["found"][:, None], f["result"], 0)}
        else:
            g = {"result": torch.where(active, f["result"].long(), 0)}
        out.append((short, g))
    return out


def diff(a, b) -> int:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b).to(a.device)
        if a.shape != b.shape:
            return max(a.numel(), b.numel(), 1)
        return int((a.long() != b.long()).sum())
    return int(a != b)


def decisions(prog_calls, ref_calls) -> int:
    """Differing statistics and sub-round outcome elements over the driver
    calls: each ``(stats dict, log)``."""
    n = abs(len(prog_calls) - len(ref_calls))
    for (ps, pl), (rs, rl) in zip(prog_calls, ref_calls):
        n += sum(diff(ps[k], rs[k]) for k in rs) + len(set(ps) ^ set(rs))
        n += abs(len(pl) - len(rl)) * 1000
        for (pn, pf), (rn, rf) in zip(pl, rl):
            if pn != rn:
                n += 1000
                continue
            n += sum(diff(pf[k], rf[k]) for k in rf)
    return n


def state(prog: dict, ref) -> dict:
    """Differences of the final state (``prog`` from
    ``cell.Deployment.outcome``, ``ref`` a ``RefTPCC``)."""
    out = {}
    if prog["cur_hdr"].shape[0] != ref.lay.R:
        out["rows"] = max(prog["cur_hdr"].shape[0], ref.lay.R)
    else:
        dev = ref.dev
        hdr = prog["cur_hdr"].to(dev)
        data = prog["cur_data"].to(dev)
        bad = (hdr[:, 0] != ref.cur_meta) | (hdr[:, 1] != ref.cur_cts) \
            | (data != ref.cur_data).any(dim=1)
        out["rows"] = int(bad.sum())
    out["vector"] = diff(prog["vec"], ref.vec)
    keys = torch.where(ref.idx_keys == (1 << 32) - 1, SENTINEL32,
                       ref.idx_keys)
    out["index"] = diff(prog["idx_keys"], keys) \
        + diff(prog["idx_vals"], ref.idx_vals) \
        + int((prog["idx_base"] != SENTINEL32).sum())
    out["cursors"] = diff(prog["o_cursor"], ref.o_cursor) \
        + diff(prog["h_cursor"], ref.h_cursor)
    return out


def failed(calls, outcome_start: dict, outcome_end: dict) -> int:
    """Commits whose insert was not made: new-orders without their order,
    payments without their history record, over the driver calls."""
    no = pay = 0
    for stats, _ in calls:
        no += stats.get("commits.neworder", stats.get("commits", 0))
        pay += stats.get("commits.payment", 0)
    d_o = int((outcome_end["o_cursor"] - outcome_start["o_cursor"]).sum())
    d_h = int((outcome_end["h_cursor"] - outcome_start["h_cursor"]).sum())
    return (no - d_o) + (pay - d_h)


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def lines(numbers: dict) -> list:
    return [f"{k} {numbers[k]} limit {LIMITS[k]}" for k in LIMITS]
