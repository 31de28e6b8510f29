"""Run checks of the seven kernels on the card: the port's stand-ins for
the kernel rules that walk Pallas bodies in the JAX package (K1, K2).

Each kernel is launched through its ``ops`` wrapper at small shapes, on
adversarial inputs of the kind ``chip_smoke.py`` phase 3 builds: slots
out of range and padding lanes, directory misses and invalidated entries,
unmapped pages and ``kv_len = 0``, query rows that see no key, ragged
tiles. Every run is guarded:

* every CUDA buffer the launch touches (the inputs, and everything the
  wrapper allocates, caught at its factory op by a ``TorchDispatchMode``)
  sits between two 4 KiB margins of a canary byte, which must come back
  intact: a write out of range near a buffer (K1);
* every buffer the wrapper allocates uninitialised is filled with a
  poison byte, 0x00 in the first and third run and 0xFF in the second;
  runs 1 and 2 must agree bit for bit, or the kernel read memory it never
  wrote (the class of compute-sanitizer's initcheck, and of a commit
  scratch buffer once read before it was written); runs 1 and 3 must
  agree, or two launches on the same inputs differ (a race, K2);
* the result must equal the plain version (bit for bit for the protocol
  kernels, within ``kernels/tolerance.py`` for the LM kernels) under the
  kernel's own contract for the adversarial lanes.

``compute-sanitizer`` would see reads out of range and races that change
no result as well; it refuses the H100 the port is measured on ("Device
not supported"), so these checks are what the port has: :func:`run_all`
(``chip_smoke.py`` phase 17, ``python -m repro_torch.analysis`` on the
card).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._u32 import np_to_i32
from repro_torch.analysis.rules import Finding
from repro_torch.kernels.tolerance import TOL

CANARY = 0x5A
POISONS = (0x00, 0xFF, 0x00)
MARGIN = 4096            # bytes of canary before and after every buffer
_EMPTY = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided"}
_FILLED = {"zeros", "zeros_like", "new_zeros", "full", "full_like",
           "new_full", "ones", "ones_like", "new_ones"}


class _Buffers:
    """The guarded buffers of one run: each a uint8 base tensor whose
    middle holds the data."""

    def __init__(self):
        self.bases: List[Tuple[torch.Tensor, int]] = []

    def place(self, t: torch.Tensor, fill=None) -> torch.Tensor:
        """A copy of ``t`` on the card inside canary margins; ``fill``, a
        byte, replaces its contents (an uninitialised buffer)."""
        n = t.numel() * t.element_size()
        base = torch.full((n + 2 * MARGIN,), CANARY, dtype=torch.uint8,
                          device="cuda")
        mid = base[MARGIN:MARGIN + n]
        if fill is not None:
            mid.fill_(fill)
        else:
            mid.copy_(t.detach().contiguous().reshape(-1).view(torch.uint8))
        self.bases.append((base, n))
        return mid.view(t.dtype).view(t.shape)

    def intact(self) -> bool:
        """Every margin still holds the canary (one sync)."""
        if not self.bases:
            return True
        ok = torch.stack([(torch.cat([b[:MARGIN], b[MARGIN + n:]])
                           == CANARY).all() for b, n in self.bases])
        return bool(ok.all())


class _Guard(TorchDispatchMode):
    """Places every contiguous CUDA buffer a wrapper allocates inside
    canary margins: an uninitialised one filled with ``poison``, a filled
    one with its values."""

    def __init__(self, buffers: _Buffers, poison: int):
        super().__init__()
        self.buffers, self.poison = buffers, poison

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if (name in _EMPTY or name in _FILLED) \
                and isinstance(out, torch.Tensor) \
                and out.device.type == "cuda" and out.numel() \
                and out.is_contiguous():
            return self.buffers.place(
                out, self.poison if name in _EMPTY else None)
        return out


@dataclasses.dataclass
class Case:
    """One kernel's adversarial launch: ``make()`` gives its CPU inputs
    ``(args, kwargs)``; ``launch(args, kwargs)`` calls the wrapper and
    returns the tensors to compare (outputs and every input it writes);
    ``expect(args, kwargs, got)`` raises unless ``got`` (on the CPU)
    honors the plain version."""
    kernel: str
    make: Callable
    launch: Callable
    expect: Callable
    counter: Callable     # the wrapper whose ``launches`` it counts


@dataclasses.dataclass
class Result:
    kernel: str
    launches: int = 0
    margins_intact: bool = False
    poisons_agree: bool = False     # runs 1 and 2: no uninitialised read
    repeats_agree: bool = False     # runs 1 and 3: no race seen
    plain: str = ""                 # "" when it holds, else why not


def _on_card(x, buffers: _Buffers):
    if isinstance(x, torch.Tensor):
        return buffers.place(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_on_card(y, buffers) for y in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_on_card(y, buffers) for y in x)
    return x


def _cpu(x):
    return [t.cpu() if isinstance(t, torch.Tensor) else t for t in x]


def _bits_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x is None and y is None or (x.dtype == y.dtype
                                    and torch.equal(x.view(torch.uint8),
                                                    y.view(torch.uint8)))
        for x, y in zip(a, b))


def check(case: Case) -> Result:
    """Three guarded runs of ``case`` on the card."""
    res = Result(case.kernel)
    runs, intact = [], True
    before = case.counter().launches
    for poison in POISONS:
        args, kw = case.make()
        buffers = _Buffers()
        args, kw = _on_card(args, buffers), _on_card(kw, buffers)
        with _Guard(buffers, poison):
            got = case.launch(args, kw)
        torch.cuda.synchronize()
        intact &= buffers.intact()
        runs.append(_cpu(got))
    res.launches = case.counter().launches - before
    res.margins_intact = intact
    res.poisons_agree = _bits_equal(runs[0], runs[1])
    res.repeats_agree = _bits_equal(runs[0], runs[2])
    try:
        args, kw = case.make()
        case.expect(args, kw, runs[0])
    except AssertionError as e:
        res.plain = str(e) or "differs from its plain version"
    return res


# --------------------------------------------------------------------------
# the adversarial cases
# --------------------------------------------------------------------------

def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np_to_i32(np.asarray(a)))


def _hdr(tid, cts, flags):
    return np.stack([(np.asarray(tid, np.uint32) << 3) | flags,
                     np.asarray(cts, np.uint32)], axis=-1).astype(np.uint32)


def _table(rng, R=48, K=2, KO=4, W=4, n_ts=4):
    """Populated rings: thread ids past the vector, commit stamps near
    2**32, deleted and moved bits, never-written sentinels, ring counters
    past several revolutions."""
    from repro_torch.core.mvcc import VersionedTable

    def hdrs(shape, moved_p, deleted_p):
        tid = rng.randint(0, n_ts + 3, shape)
        cts = rng.randint(0, 12, shape).astype(np.uint32)
        cts = np.where(rng.rand(*shape) < 0.1, np.uint32(0xFFFFFFF0), cts)
        flags = (np.where(rng.rand(*shape) < moved_p, 4, 0)
                 | np.where(rng.rand(*shape) < deleted_p, 2, 0))
        return _hdr(tid, cts, flags)

    old = hdrs((R, K), 0.5, 0.1)
    old[rng.rand(R, K) < 0.25] = _hdr(0, 0, 4)
    tbl = VersionedTable(
        cur_hdr=_i32(hdrs((R,), 0.0, 0.15)),
        cur_data=_i32(rng.randint(0, 1000, (R, W)).astype(np.int32)),
        old_hdr=_i32(old),
        old_data=_i32(rng.randint(0, 1000, (R, K, W)).astype(np.int32)),
        next_write=_i32(rng.randint(0, 5 * K, R).astype(np.int32)),
        ovf_hdr=_i32(hdrs((R, KO), 0.0, 0.3)),
        ovf_data=_i32(rng.randint(0, 1000, (R, KO, W)).astype(np.int32)),
        ovf_next=_i32(rng.randint(0, KO, R).astype(np.int32)))
    ts = rng.randint(0, 12, n_ts).astype(np.uint32)
    ts[-1] = np.uint32(0xFFFFFFFF)
    return tbl, _i32(ts)


def _directory(rng, R, n_buckets=128):
    """A directory of R keys (some near 2**32), two entries invalidated."""
    from repro_torch.core import hashtable as ht
    keys = (np.arange(1, R + 1, dtype=np.uint64) * 2654435761 % (1 << 32)
            ).astype(np.uint32)
    keys[:3] = [0xFFFFFFFE, 0xFFFFFFFD, 0x80000000]
    d, placed = ht.insert(ht.init(n_buckets, device="cpu"), _i32(keys),
                          torch.arange(R, dtype=torch.int32), max_probes=32)
    d.vals[placed[3:5].long()] = -1
    return d, keys


def _lanes(rng, keys, Q):
    """Query keys: hits, duplicates, absent keys, a key whose +1 wraps."""
    lane = keys[rng.randint(0, len(keys), Q)]
    lane[1::5] = lane[0]
    lane[rng.rand(Q) < 0.2] = np.uint32(0xDEADBEEF)
    lane[7] = np.uint32(0xFFFFFFFF)
    return lane


def _probe_make(seed):
    def make():
        rng = np.random.RandomState(seed)
        tbl, ts = _table(rng)
        d, keys = _directory(rng, tbl.n_records)
        Q = 96
        key_mask = rng.rand(Q) < 0.6
        fallback = rng.randint(0, tbl.n_records, Q).astype(np.int32)
        fallback[[2, 9, 11, 13]] = [-3, tbl.n_records + 5,
                                    -tbl.n_records - 1, tbl.n_records]
        key_mask[[2, 9, 11, 13]] = False
        return (d.keys, d.vals, tbl, ts, _i32(fallback),
                _i32(_lanes(rng, keys, Q)), torch.from_numpy(key_mask)), \
            {"max_probes": 32}
    return make


def _equal(got, want, names):
    for n, g, w in zip(names, got, want):
        assert torch.equal(g, w.cpu()), f"{n} differs from the plain version"


def _probe_cases() -> List[Case]:
    from repro_torch.kernels.hash_probe import ops, ref
    out = ("slot", "found", "src", "pos")

    def batched(args, kw):
        return list(ops.batched_probe(*args, **kw))

    def hashed(args, kw):
        return list(ops.hash_probe(*args[:4], args[5], **kw))

    return [
        Case("batched_probe", _probe_make(1), batched,
             lambda a, kw, got: _equal(got, ref.batched_probe_ref(*a, **kw),
                                       out),
             lambda: ops.batched_probe),
        Case("hash_probe", _probe_make(2), hashed,
             lambda a, kw, got: _equal(
                 got, ref.hash_probe_ref(*a[:4], a[5], **kw), out),
             lambda: ops.hash_probe),
    ]


def _commit_make():
    """T = 8 transactions of WS = 4 requests: slots R-1, R, R+5, -1, -R and
    -R-1 among them, records written twice, inactive (padding) lanes,
    expectations that match and that do not, one transaction not ok."""
    rng = np.random.RandomState(5)
    tbl, _ = _table(rng, R=40, K=2, KO=4, W=4)
    R, T, WS, W = tbl.n_records, 8, 4, tbl.payload_width
    Q = T * WS
    slots = rng.randint(0, R, Q).astype(np.int32)
    slots[[1, 5, 9, 13, 17, 21]] = [R - 1, R, R + 5, -1, -R, -R - 1]
    slots[[2, 3]] = slots[30]                 # written twice
    active = rng.rand(Q) < 0.85
    tbl.cur_hdr[:, 0] &= ~1                   # nothing locked yet
    expected = tbl.cur_hdr[torch.from_numpy(slots).long().clamp(0, R - 1)]
    expected[torch.from_numpy(rng.rand(Q) < 0.2), 1] += 1   # stale
    prio = torch.arange(T, dtype=torch.int32).repeat_interleave(WS)
    prio[[8, 9]] = 0                          # a tie beside a slot R + 5
    txn = torch.arange(T, dtype=torch.int32).repeat_interleave(WS)
    txn_ok = torch.ones((T,), dtype=torch.bool)
    txn_ok[3] = False
    vec = _i32(rng.randint(0, 20, T).astype(np.uint32))
    cts = _i32(np.full(T, 21, np.uint32))
    new_hdr = torch.stack([txn << 3, cts[txn.long()]], dim=1)
    args = (tbl, vec, torch.from_numpy(slots), expected, prio,
            torch.from_numpy(active), txn,
            new_hdr, _i32(rng.randint(0, 1000, (Q, W)).astype(np.int32)),
            txn_ok, torch.arange(T, dtype=torch.int32), cts,
            torch.zeros((T,), dtype=torch.int32))
    return args, {}


def _commit_case() -> Case:
    from repro_torch.kernels.commit import ops, ref

    def launch(args, kw):
        out = ops.fused_commit(*args, **kw)
        return [*out.table, out.vec, out.granted, out.committed,
                out.do_install, out.fails]

    def expect(args, kw, got):
        out = ref.fused_commit_ref(*args, **kw)
        want = [*out.table, out.vec, out.granted, out.committed,
                out.do_install, out.fails]
        _equal(got, want, [*out.table._fields, "vec", "granted",
                           "committed", "do_install", "fails"])
    return Case("fused_commit", _commit_make, launch, expect,
                lambda: ops.fused_commit)


def _close(got, want, tol, what):
    g, w = got.float(), want.float().cpu()
    bad = (g - w).abs() > tol + tol * w.abs()
    assert not bad.any() and torch.isfinite(g).all(), \
        f"{what}: {int(bad.sum())} values beyond atol = rtol = {tol}"


def _lm_cases() -> List[Case]:
    from repro_torch.kernels.flash_attention import ops as fa, ref as far
    from repro_torch.kernels.mamba_scan import ops as ms, ref as msr
    from repro_torch.kernels.moe_gmm import ops as mg, ref as mgr
    from repro_torch.kernels.paged_attention import ops as pa, ref as par
    bf = torch.bfloat16
    tol = lambda k: TOL[k]["bfloat16"]  # noqa: E731

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # flash, bf16 (the tensor-core route): Sq = 40 against Sk = 24 keys,
    # causal, window 5, so rows 28-39 see no key (the kernel's contract:
    # 0 there); a ragged tile of 40 rows in a block of 128
    def flash_make():
        g = gen(6)
        return tuple(torch.randn(s, generator=g).to(bf) for s in
                     ((1, 40, 4, 64), (1, 24, 2, 64), (1, 24, 2, 64))), \
            {"causal": True, "window": 5}

    def flash_expect(args, kw, got):
        plain = far.flash_attention_ref(*(a.float() for a in args), **kw)
        _close(got[0][:, :28], plain[:, :28], tol("flash_attention"),
               "flash_attention rows with keys")
        assert not got[0][:, 28:].any(), "a row without keys is not 0"

    # paged, bf16: pages of 256 tokens, 2 a partition (so the merge runs),
    # an unmapped page inside kv_len, kv_len = 0, unmapped table tails
    ps = 256
    table = [[3, -1, 7, 11, 9], [0, 1, 2, 4, 5], [20, 21, -1, -1, -1]]

    def paged_make():
        g = gen(7)
        q = torch.randn(3, 4, 64, generator=g).to(bf)
        kp, vp = (torch.randn(24, ps, 2, 64, generator=g).to(bf)
                  for _ in range(2))
        kl = torch.tensor([4 * ps + 7, 0, ps + 1], dtype=torch.int32)
        return (q, kp, vp, torch.tensor(table, dtype=torch.int32), kl), {}

    def paged_expect(args, kw, got):
        q, kp, vp, _, _ = (a.float() if a.is_floating_point() else a
                           for a in args)
        dropped = torch.tensor([[3, 7, 11, 9, -1], table[1], table[2]],
                               dtype=torch.int32)
        kl = torch.tensor([3 * ps + 7, 0, ps + 1], dtype=torch.int32)
        plain = par.paged_attention_ref(q, kp, vp, dropped, kl)
        assert not got[0][1].any(), "kv_len = 0 does not give 0"
        _close(got[0][0::2], plain[0::2], tol("paged_attention"),
               "paged_attention, an unmapped page dropped")

    # the expert FFN, bf16: C = 40 rows (a partial tile), D 64, F 128
    def moe_make():
        g = gen(8)
        return ((torch.randn(2, 40, 64, generator=g) * 0.5).to(bf),
                *((torch.randn(s, generator=g) * 0.2).to(bf) for s in
                  ((2, 64, 128), (2, 64, 128), (2, 128, 64)))), {}

    def moe_expect(args, kw, got):
        plain = mgr.moe_gmm_ref(*(a.float() for a in args), **kw)
        _close(got[0], plain, tol("moe_gmm"), "moe_gmm")

    # the scan, bf16: S = 37 (the wrapper pads the steps), Di = 20 (and
    # the channels), N = 12 (and the states)
    def scan_make():
        g = gen(9)
        B, S, Di, N = 2, 37, 20, 12
        dt = torch.nn.functional.softplus(torch.randn(B, S, Di, generator=g))
        return (dt.to(bf), torch.randn(B, S, Di, generator=g).to(bf),
                (torch.randn(B, S, N, generator=g) * 0.3).to(bf),
                (torch.randn(B, S, N, generator=g) * 0.3).to(bf),
                torch.log(torch.arange(1, N + 1).float()[None]
                          .expand(Di, N) * 1.1),
                torch.linspace(0.5, 1.5, Di)), {"return_state": True}

    def scan_expect(args, kw, got):
        y, h = msr.mamba_scan_ref(*args, **kw)
        _close(got[0], y, tol("mamba_scan"), "mamba_scan y")
        _close(got[1], h, tol("mamba_scan"), "mamba_scan last state")

    return [
        Case("flash_attention", flash_make,
             lambda a, kw: [fa.flash_attention(*a, **kw)], flash_expect,
             lambda: fa.flash_attention),
        Case("paged_attention", paged_make,
             lambda a, kw: [pa.paged_attention(*a, **kw)], paged_expect,
             lambda: pa.paged_attention),
        Case("moe_gmm", moe_make, lambda a, kw: [mg.moe_gmm(*a, **kw)],
             moe_expect, lambda: mg.moe_gmm),
        Case("mamba_scan", scan_make,
             lambda a, kw: list(ms.mamba_scan(*a, **kw)), scan_expect,
             lambda: ms.mamba_scan),
    ]


def cases() -> Dict[str, Case]:
    """The adversarial launch of each kernel of ``_build.KERNELS``."""
    return {c.kernel: c for c in
            _probe_cases() + [_commit_case()] + _lm_cases()}


def findings_of(res: Result) -> List[Finding]:
    """A result's failures as K1/K2 findings."""
    out = []

    def add(rule, msg):
        out.append(Finding(rule=rule, level="kernel", file=res.kernel,
                           line=0, msg=msg))
    if res.launches != len(POISONS):
        add("K1", f"{res.launches} launches for {len(POISONS)} runs: the "
                  "wrapper did not launch its kernel")
    if not res.margins_intact:
        add("K1", "a canary margin around a buffer was overwritten: a "
                  "write out of range")
    if not res.poisons_agree:
        add("K1", "runs over buffers poisoned with 0x00 and 0xFF differ: "
                  "the kernel reads memory it never wrote")
    if not res.repeats_agree:
        add("K2", "two runs on the same inputs and poison differ: a race")
    if res.plain:
        add("K1", f"against its plain version: {res.plain}")
    return out


def run_all() -> Tuple[List[Finding], List[Result]]:
    """Check every kernel on the card; builds what it launches. Returns
    the findings and a result a kernel."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel run checks need a CUDA card")
    results = [check(c) for c in cases().values()]
    return [f for r in results for f in findings_of(r)], results
