"""Level 1: dispatch-level audit of the port's protocol entry points.

Runs the real entry points (``si.run_round``, ``store.distributed_round``,
``wal.replay``, ``gc.gc_round``) on small deterministic fixtures, under a
``TorchDispatchMode`` that sees every ATen op on real tensors, and checks
the invariants the AST lint only approximates. ``torch.fx`` cannot trace
these paths: they sync on data (``_u32.rows_of`` is ``nonzero``), so the
audit follows the run itself, as ``launch/hlostats.OpCounter`` does.

* **Taint** is kept per storage, so views and in-place ops carry it: an
  op's outputs, and every argument it mutates, take the union of its
  inputs' taint; an op it does not know passes taint on. A value read to
  the host (``_local_scalar_dense``, ``tolist``, ``numpy``) loses its
  tensor identity, so a tensor made afterwards from host data (a factory
  op, ``torch.tensor``) takes the union of the tags read to the host so
  far. The walk is over-approximate: it may miss a leak, but it never
  invents a missing flow.
* **A1 (lock pairing)**: the commit path tags its CAS grant mask, release
  mask and commit decision with :func:`repro_torch.core.annotations.tag`;
  the grant tag must flow into both the release tag and the commit tag.
* **A2 (overflow-unsafe reductions)**: the fixture marks its timestamp
  planes (the oracle vector, the header words, a journal's ``ts_vec``, a
  snapshot log's ``vecs``); the "timestamp" label follows int32 values
  derived from them and is cleared by widening (any non-int32 result),
  the 16-bit digit split (``& 0xFFFF``, ``>> 16``), a comparison or a
  ``where``. A ``sum``, ``cumsum``, ``amin`` or ``amax`` of an int32
  operand that still carries it is W02.
* **A3 (sentinel-blind selection)**: an ``argmin``/``argmax`` whose
  operand is neither boolean (nor a bool widened to an integer) nor the
  output of a ``where`` is W03.
* **A4 (journal width)**: ``wal.append_intent`` raises ``[A4]`` on a width
  mismatch; the audit turns that into W04.

Findings map back to source through the Python stack (the innermost frame
outside torch, the standard library and this module) and honor the same
``# analysis: safe(...)`` comments as the AST lint. Entry points run on
``cuda`` unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._device import resolve_device
from repro_torch.analysis.rules import Finding, apply_suppressions
from repro_torch.core import annotations as anno

_SKIP_DIRS = tuple(os.path.dirname(m.__file__) + os.sep
                   for m in (torch, os))
_SKIP_FILES = {os.path.abspath(__file__), os.path.abspath(anno.__file__)}

_REDUCTIONS = {"sum", "cumsum", "amin", "amax", "min", "max"}
_SELECTIONS = {"argmin", "argmax"}
_WHERE = {"where"}
# ops whose output is their input's value, moved or re-laid out: the A3
# origin looks through them at argument 0
_PASSTHRU = {"_to_copy", "clone", "contiguous", "detach", "alias", "view",
             "reshape", "_unsafe_view", "expand", "squeeze", "unsqueeze",
             "permute", "transpose", "t", "slice", "select", "flatten",
             "lift_fresh", "lift_fresh_copy", "_reshape_alias"}
_TIMESTAMP_DTYPE = torch.int32

_REQUIRED_TAGS = (anno.LOCK_GRANTED, anno.LOCK_RELEASED,
                  anno.COMMIT_COMMITTED)


def _user_frame() -> Tuple[str, int]:
    """(file, line) of the innermost frame outside torch, the standard
    library, this module and ``annotations.py``."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith("<") or fn.startswith(_SKIP_DIRS)
                or os.path.abspath(fn) in _SKIP_FILES):
            return fn, f.f_lineno
        f = f.f_back
    return "<graph>", 0


@dataclasses.dataclass
class _Info:
    """What the audit knows of one storage."""
    tags: frozenset = frozenset()
    timestamp: bool = False
    origin: str = "other"     # A3: "bool" | "select" | "other"


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _scalar(x) -> Optional[int]:
    """A Python int operand (a tensor operand is not read: that would
    sync)."""
    return x if isinstance(x, int) and not isinstance(x, bool) else None


@dataclasses.dataclass
class _Ctx:
    entry: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    tag_sites: Dict[str, List[Tuple[str, int]]] = \
        dataclasses.field(default_factory=dict)
    tag_inputs: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    n_ops: int = 0

    def add(self, rule: str, msg: str, site=None) -> None:
        file, line = site if site is not None else _user_frame()
        self.findings.append(Finding(
            rule=rule, level="graph", file=file, line=line,
            msg=f"[{self.entry}] {msg}"))


class _Audit(TorchDispatchMode):
    """The op-level half: taint, labels and the A2/A3 checks."""

    def __init__(self, ctx: _Ctx):
        super().__init__()
        self.ctx = ctx
        self.info: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.host: frozenset = frozenset()

    def of(self, t: torch.Tensor) -> _Info:
        return self.info.get(t.untyped_storage(), _Info())

    def put(self, t: torch.Tensor, info: _Info) -> None:
        self.info[t.untyped_storage()] = info

    def mark(self, t: torch.Tensor, **kw) -> None:
        self.put(t, dataclasses.replace(self.of(t), **kw))

    def read_to_host(self, t: torch.Tensor) -> None:
        self.host = self.host | self.of(t).tags

    # ---- the checks --------------------------------------------------------
    def _check(self, name: str, overload: str, args, kwargs) -> None:
        op = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if op is None:
            return
        if name in _REDUCTIONS and op.dtype == _TIMESTAMP_DTYPE \
                and overload != "other" \
                and self.of(op).timestamp \
                and kwargs.get("dtype") in (None, torch.int32):
            self.ctx.add("W02", f"int32 `{name}` over uint32 timestamp "
                         "words without _u32.u64 widening or the exact (hi, "
                         "lo) base-2^16 digit split — a word past 2^31 "
                         "counts as negative, a 32-bit sum wraps, and "
                         "either inverts timestamp dominance")
        elif name in _SELECTIONS and op.dtype != torch.bool \
                and self.of(op).origin not in ("bool", "select"):
            self.ctx.add("W03", f"`{name}` over a {op.dtype} operand that "
                         "is neither boolean nor where-masked — a "
                         "-1/0xFFFFFFFF sentinel hijacks the selection")

    # ---- what an op's outputs inherit --------------------------------------
    def _label(self, name, args, ins, out: torch.Tensor) -> bool:
        """The timestamp label of an int32 result."""
        if out.dtype != _TIMESTAMP_DTYPE or name in _WHERE \
                or not any(self.of(t).timestamp for t in ins):
            return False
        if name == "bitwise_and":
            v = next((_scalar(a) for a in args[1:2]), None)
            return v is None or v > 0xFFFF       # & 0xFFFF: the low digit
        if name in ("bitwise_right_shift", "__rshift__"):
            v = next((_scalar(a) for a in args[1:2]), None)
            return v is None or v < 16           # >> 16: the high digit
        return True

    def _origin(self, name, ins, out: torch.Tensor) -> str:
        if out.dtype == torch.bool:
            return "bool"
        if name in _WHERE:
            return "select"
        if name in _PASSTHRU and ins:
            src = ins[0]
            return "bool" if src.dtype == torch.bool else self.of(src).origin
        return "other"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.ctx.n_ops += 1
        self._check(name, func._overloadname, args, kwargs)
        ins = list(_tensors((args, kwargs)))
        tags = frozenset().union(*(self.of(t).tags for t in ins)) \
            if ins else self.host
        if name.startswith("lift_fresh"):
            tags = tags | self.host
        out = func(*args, **kwargs)
        if name == "_local_scalar_dense":     # .item(), bool(), int()
            self.host = self.host | tags
            return out
        # every argument the op writes takes the union, and loses what
        # A3 knew of its origin
        for a, spec in zip(args, func._schema.arguments):
            if isinstance(a, torch.Tensor) and spec.alias_info is not None \
                    and spec.alias_info.is_write:
                old = self.of(a)
                self.put(a, _Info(
                    old.tags | tags,
                    old.timestamp or self._label(name, args, ins, a),
                    "select" if name in _WHERE else "other"))
        in_storages = {t.untyped_storage() for t in ins}
        for t in _tensors(out):
            if t.untyped_storage() in in_storages:   # a view, or in place
                old = self.of(t)
                self.put(t, dataclasses.replace(old, tags=old.tags | tags))
            else:
                self.put(t, _Info(tags, self._label(name, args, ins, t),
                                  self._origin(name, ins, t)))
        return out


class _HostReads(TorchFunctionMode):
    """The host reads the dispatcher never sees (``tolist``, ``numpy``)."""

    def __init__(self, audit: _Audit):
        super().__init__()
        self.audit = audit

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("tolist", "numpy", "__array__"):
            for t in _tensors(args):
                self.audit.read_to_host(t)
        return func(*args, **(kwargs or {}))


class _Running:
    """The audit of one call: both modes, and the tag hook."""

    def __init__(self, ctx: _Ctx, sources=()):
        self.ctx = ctx
        self.audit = _Audit(ctx)
        for t in sources:
            self.audit.mark(t, timestamp=True)

    def hook(self, full_name: str, x: torch.Tensor) -> None:
        name = full_name[len(anno._NAMESPACE):]
        info = self.audit.of(x)
        self.ctx.tag_sites.setdefault(name, []).append(_user_frame())
        self.ctx.tag_inputs.setdefault(name, set()).update(info.tags)
        self.audit.put(x, dataclasses.replace(info, tags=info.tags | {name}))

    def run(self, fn, *args, **kwargs):
        prev, anno._hook = anno._hook, self.hook
        try:
            with _HostReads(self.audit), self.audit:
                return fn(*args, **kwargs)
        finally:
            anno._hook = prev


def _check_lock_pairing(ctx: _Ctx) -> None:
    """A1: the grant mask must reach both the release tag and the commit
    tag."""
    missing = [t for t in _REQUIRED_TAGS if t not in ctx.tag_sites]
    if missing:
        site = ctx.tag_sites.get(anno.LOCK_GRANTED, [("<graph>", 0)])[0]
        ctx.add("W01", f"protocol tags absent from the run: {missing} — a "
                "CAS-acquire path lost its release/commit pairing (or its "
                "annotations.tag calls)", site)
        return
    for consumer in (anno.LOCK_RELEASED, anno.COMMIT_COMMITTED):
        if anno.LOCK_GRANTED not in ctx.tag_inputs.get(consumer, set()):
            ctx.add("W01", f"the CAS grant mask does not flow into "
                    f"`{consumer}` — locks leak on that outcome path",
                    ctx.tag_sites[consumer][0])


@dataclasses.dataclass
class EntrypointReport:
    name: str
    status: str       # "ok" | "error"
    detail: str = ""
    n_ops: int = 0        # ATen ops the run dispatched
    n_findings: int = 0   # active (unsuppressed) findings
    # tag -> {"sites": n, "from": tags that flow into it}
    tags: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _tag_summary(ctx: _Ctx) -> Dict[str, dict]:
    return {t: {"sites": len(s), "from": sorted(ctx.tag_inputs.get(t, ()))}
            for t, s in sorted(ctx.tag_sites.items())}


def _audit(ctx: _Ctx, fn, args, kwargs, sources, expects_locks) -> None:
    try:
        _Running(ctx, sources).run(fn, *args, **kwargs)
    except ValueError as e:
        if "[A4]" not in str(e):
            raise
        ctx.add("W04", f"{e}", ("<graph>", 0))
        return
    if expects_locks:
        _check_lock_pairing(ctx)


def audit_callable(fn, *args, name: str = "callable",
                   expects_locks: bool = False, sources=(),
                   **kwargs) -> Tuple[List[Finding], EntrypointReport]:
    """Run ``fn(*args, **kwargs)`` under the audit: the corpus tests' and
    ``chip_smoke.py``'s entry hook. ``sources`` are the tensors whose
    storages carry the timestamp label from the start. An [A4] width-guard
    trip becomes a W04 finding. Returns ``(findings, report)``,
    suppressions applied."""
    ctx = _Ctx(entry=name)
    _audit(ctx, fn, args, kwargs, sources, expects_locks)
    apply_suppressions(ctx.findings)
    return ctx.findings, EntrypointReport(
        name, "ok", n_ops=ctx.n_ops,
        n_findings=sum(1 for f in ctx.findings if not f.suppressed),
        tags=_tag_summary(ctx))


# --------------------------------------------------------------------------
# entry-point fixtures: small deterministic protocol states (the JAX
# package's shapes); each returns (fn, args, timestamp sources)
# --------------------------------------------------------------------------

def _fixture(dev, n_threads: int = 6, n_records: int = 32, rs: int = 3,
             ws: int = 2, width: int = 4):
    from repro_torch.core import mvcc, wal
    from repro_torch.core.si import TxnBatch
    from repro_torch.core.tsoracle import VectorOracle
    oracle = VectorOracle(n_threads)
    table = mvcc.init_table(n_records, width, device=dev)
    state = oracle.init(device=dev)
    T = n_threads
    i32 = dict(dtype=torch.int32, device=dev)
    batch = TxnBatch(
        tid=torch.arange(T, **i32),
        read_slots=torch.arange(T * rs, **i32).reshape(T, rs) % n_records,
        read_mask=torch.ones((T, rs), dtype=torch.bool, device=dev),
        write_ref=torch.arange(ws, **i32).repeat(T, 1),
        write_mask=torch.ones((T, ws), dtype=torch.bool, device=dev))
    journal = wal.init_journal(T, capacity=4, n_slots=oracle.n_slots,
                               ws=ws, width=width, device=dev)
    return oracle, table, state, batch, journal


def _planes(table, *more):
    """The timestamp sources: the header planes and ``more``."""
    return (table.cur_hdr, table.old_hdr, table.ovf_hdr) + more


def _run_round(dev):
    from repro_torch.core import si
    oracle, table, state, batch, journal = _fixture(dev)
    ws = batch.write_ref.shape[1]

    def fn():
        return si.run_round(table, oracle, state, batch,
                            lambda rh, rd, v: rd[:, :ws, :] + 1,
                            journal=journal)
    return fn, _planes(table, state.vec, journal.ts_vec)


def _distributed_round(dev):
    from repro_torch.core import store
    # 5 threads over 2 servers: a non-dividing vector, so the pad_vector
    # path is part of the audited surface
    n_shards = 2
    oracle, table, state, batch, journal = _fixture(dev, n_threads=5)
    round_fn, _ = store.distributed_round(
        n_shards, oracle,
        lambda rh, rd, v, aux: rd[:, :batch.write_ref.shape[1], :] + 1,
        table.n_records // n_shards, shard_vector=True, with_journal=True)
    vec, _ = store.pad_vector(state.vec, n_shards)

    def fn():
        return round_fn(table, vec, batch, None, journal=journal)
    return fn, _planes(table, vec, journal.ts_vec)


def _replay(dev):
    from repro_torch.core import wal
    _, table, state, batch, j = _fixture(dev)
    T, ws, width = batch.tid.shape[0], 2, 4
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)  # noqa
    for seq in range(2):
        # analysis: safe(W04): fixture builds exact journal-width arrays
        wal.append_intent(j, batch.tid, state.vec, z(T, ws), z(T, ws, 2),
                          z(T, ws, width),
                          torch.ones((T, ws), dtype=torch.bool, device=dev),
                          round_no=0, seq=seq)
        wal.append_outcome(j, batch.tid,
                           torch.ones((T,), dtype=torch.bool, device=dev))
    return (lambda: wal.replay(j, table)), _planes(table, j.ts_vec)


def _gc_round(dev):
    from repro_torch.core import gc as gc_ops
    oracle, table, state, _, _ = _fixture(dev)
    log = gc_ops.init_log(4, oracle.n_slots, device=dev)
    return ((lambda: gc_ops.gc_round(table, state.vec, log, 100, 10)),
            _planes(table, state.vec, log.vecs))


# name -> (fixture, expects_locks): expects_locks entry points contain a
# CAS acquire and must satisfy the full A1 pairing contract. Both protocol
# entry points run with their default flags, unfused (DESIGN.md §7 scope).
ENTRYPOINTS: Dict[str, Tuple[Callable, bool]] = {
    "si.run_round": (_run_round, True),
    "store.distributed_round": (_distributed_round, True),
    "wal.replay": (_replay, False),
    "gc.gc_round": (_gc_round, False),
}


def audit_tree(device=None) -> Tuple[List[Finding], List[EntrypointReport]]:
    """Run and audit every registered entry point on ``device`` (default
    ``cuda``). Findings are deduped by (rule, file, line): shared helpers
    (mvcc, wal) run under several entry points."""
    dev = resolve_device(device)
    findings: List[Finding] = []
    reports: List[EntrypointReport] = []
    seen: Set[Tuple[str, str, int]] = set()
    for name, (fixture, expects_locks) in ENTRYPOINTS.items():
        try:
            fn, sources = fixture(dev)
            fs, rep = audit_callable(fn, name=name,
                                     expects_locks=expects_locks,
                                     sources=sources)
        except Exception as e:  # an entry point that cannot run is a bug
            reports.append(EntrypointReport(
                name, "error", detail=f"{type(e).__name__}: {e}"))
            continue
        fresh = [f for f in fs if (f.rule, f.file, f.line) not in seen]
        seen.update((f.rule, f.file, f.line) for f in fresh)
        findings.extend(fresh)
        rep.n_findings = sum(1 for f in fresh if not f.suppressed)
        reports.append(rep)
    return findings, reports
