"""The yardstick of the kernels' rooflines, frozen: the bytes and the
32-bit words each protocol kernel call must move and touch on its inputs,
and the card's peaks (``peaks.json``).

The counts are those the program's smoke test used when the benchmark
was defined (``probe_work``, ``commit_work``, ``decide_work``): each input
byte is counted once and each output byte once, and the work a probe's
resolution needs is what these inputs need (headers examined up to the
serving version, ring counters, the distinct vector words). They read the
call's inputs and outputs only, so a call's count does not depend on the
code that does the work.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

MASK32 = 0xFFFFFFFF
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def u64(x):
    return x.to(torch.int64) & MASK32


def _mul_u32(x, m: int):
    x = u64(x)
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & MASK32


def _hash(key, n_buckets):
    """The directory's bucket of a key: Fibonacci hashing of the uint32
    word (the §5.2 index's placement rule)."""
    return _mul_u32(key, 2654435769) % n_buckets


def least_seconds(n_bytes: int, n_words: int) -> float:
    """The least time the card needs for the work: bytes over the HBM
    bandwidth or integer work over the 32-bit rate, whichever is longer."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"],
               n_words * PEAKS["ops_per_word"] / PEAKS["int32_ops_per_s"])


def _chain_work(dk, keys, live, max_probes):
    key1 = (u64(keys) + 1) & MASK32
    base = _hash(keys, dk.shape[0])
    steps = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    hit = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    done = ~live
    for p in range(max_probes):
        k = u64(dk[(base + p) % dk.shape[0]])
        steps += (~done).long()
        hit |= ~done & (k == key1)
        done = done | (k == key1) | (k == 0)
    return int(steps.sum()), int(hit.sum())


def _is_moved(h):
    return (h[..., 0] & 4) != 0


def _tid(h):
    return u64(h[..., 0]) >> 3


def _resolution_work(table, ts, slot, found, src, pos, live):
    K, KO = table.old_hdr.shape[1], table.ovf_hdr.shape[1]
    R = table.cur_hdr.shape[0]
    s = torch.where(slot >= 0, slot, 0).long().clamp(0, R - 1)
    nw = table.next_write[s].long()
    on = table.ovf_next[s].long()
    old_seen = torch.where(src == 0, 0, torch.where(
        src == 1, torch.remainder(nw - 1 - pos, K) + 1, K))
    ovf_seen = torch.where(src == 2, torch.where(
        found, torch.remainder(on - 1 - pos, KO) + 1, KO), 0)
    ages_k = torch.arange(K, device=s.device)
    ages_o = torch.arange(KO, device=s.device)
    oh = table.old_hdr[s[:, None], torch.remainder(nw[:, None] - 1 - ages_k,
                                                   K)]
    vh = table.ovf_hdr[s[:, None], torch.remainder(on[:, None] - 1 - ages_o,
                                                   KO)]
    old_ex = live[:, None] & (ages_k < old_seen[:, None])
    ovf_ex = live[:, None] & (ages_o < ovf_seen[:, None])
    sentinel = (oh[..., 1] == 0) & (_tid(oh) == 0) & _is_moved(oh)
    tids = torch.cat([_tid(table.cur_hdr[s])[live],
                      _tid(oh)[old_ex & ~sentinel], _tid(vh)[ovf_ex]])
    words = torch.unique(tids.clamp(max=ts.shape[0] - 1))
    headers = int(live.sum()) + int(old_ex.sum()) + int(ovf_ex.sum())
    counters = int((live & (src != 0)).sum()) + int((live & (src == 2)).sum())
    return headers, counters, int(words.numel())


def probe_work(args, kw, out):
    """``batched_probe``: each lane's inputs and outputs, the directory
    words its probe chain reads and one value a met key, the headers and
    ring counters its resolution examines, and each distinct ``ts_vec``
    word those headers name. Returns (bytes, words)."""
    dk, dv, table, ts, fb, keys, km = args
    slot, found, src, pos = out
    Q = fb.shape[0]
    n_bytes = Q * (4 + 13)
    words = 0
    if dk is not None:
        n_bytes += Q * 5
        n_probe, n_hit = _chain_work(dk, keys, km, kw.get("max_probes", 16))
        n_bytes += n_probe * 4 + n_hit * 4
        words += n_probe
    headers, counters, ts_words = _resolution_work(
        table, ts, slot, found, src, pos,
        torch.ones(Q, dtype=torch.bool, device=fb.device))
    n_bytes += headers * 8 + counters * 4 + ts_words * 4
    words += 2 * headers + counters
    return n_bytes, words


def commit_work(args, out):
    """``fused_commit`` (a whole commit, or a server's apply launch): each
    request's slot, priority, transaction, active flag and two output flags;
    the expected header and the header, ring counter and ring victim of each
    active request; the new header and the payload rows of each install;
    each transaction's inputs, outputs and vector slot."""
    (table, vec, slots, exp, prio, act, txn, new_hdr, new_data, txn_ok,
     txn_slot, cts, ext) = args
    Q, T, W = slots.shape[0], txn_ok.shape[0], new_data.shape[1]
    n_act = int(act.sum())
    n_inst = int(out.do_install.sum())
    n_bytes = Q * (13 + 2) + n_act * (8 + 20) + n_inst * (8 + 20 + 16 * W) \
        + T * (13 + 8 + 5)
    words = Q * 4 + n_act * 7 + n_inst * (7 + 4 * W) + T * 5
    return n_bytes, words


def decide_work(args):
    """A decide-only ``fused_commit`` launch: each request's slot, priority,
    transaction and active flag; the expected header and the header, ring
    counter and ring victim of each active request; the failure counts."""
    Q, T = args[2].shape[0], args[9].shape[0]
    n_act = int(args[5].sum())
    return Q * 13 + n_act * (8 + 20) + T * 4, Q * 4 + n_act * 7 + T


class KernelWork:
    """While active, wraps the two protocol kernels' entry points: each
    call runs, then its work is counted on its inputs and outputs (this
    waits for the device). ``seconds[name]`` sums the least times and
    ``calls[name]`` the calls."""

    def __init__(self, probe_ops, commit_ops):
        self.mods = probe_ops, commit_ops
        self.seconds = {"batched_probe": 0.0, "fused_commit": 0.0}
        self.calls = {"batched_probe": 0, "fused_commit": 0}

    def __enter__(self):
        probe_ops, commit_ops = self.mods
        self.orig = probe_ops.batched_probe, commit_ops.fused_commit
        orig_probe, orig_commit = self.orig

        def probe(*a, **k):
            out = orig_probe(*a, **k)
            self._add("batched_probe", *probe_work(a, k, out))
            return out

        def commit(*a, **k):
            out = orig_commit(*a, **k)
            if k.get("decide_only"):
                self._add("fused_commit", *decide_work(a))
            else:
                self._add("fused_commit", *commit_work(a, out))
            return out

        probe_ops.batched_probe, commit_ops.fused_commit = probe, commit
        return self

    def _add(self, name, n_bytes, n_words):
        self.seconds[name] += least_seconds(n_bytes, n_words)
        self.calls[name] += 1

    def __exit__(self, *exc):
        probe_ops, commit_ops = self.mods
        probe_ops.batched_probe, commit_ops.fused_commit = self.orig
