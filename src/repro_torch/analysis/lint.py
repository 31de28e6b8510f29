"""Level 2: AST lint over the port's source (rule ids W01-W06).

Complements the graph audit: the AST sees code paths that never run in the
audit's fixtures (every function in scope, not just the audited entry
points) at the cost of working from spellings instead of dataflow. W01-W04
mirror A1-A4, so a bug class is caught both before a run (here) and
through one (``graph_audit``). Pure stdlib: no torch import, milliseconds.

The JAX package's lint works by callee name; this one keeps those names
and adds the torch spellings: the method forms ``x.sum()``, ``x.argmax()``
(the receiver is the operand), ``sum(dtype=torch.int64)``, ``.to(
torch.int64)`` and ``_u32.u64(...)`` as widening for W02, and a
``torch.where(...)`` or a syntactically boolean tensor widened with
``.to(torch.int8)`` as a safe W03 operand. The port keeps uint32 words in
int32 tensors, so no dtype marks a timestamp: W02 reads the JAX package's
name tokens.

Heuristics are conservative but suppressible: a flagged site proven safe
carries an ``# analysis: safe(Wxx): reason`` comment (see ``rules``),
which also silences the mirrored graph finding at the same line.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, List, Optional, Set

from repro_torch.analysis.rules import Finding, apply_suppressions

# Directories linted by default (relative to the repo root). models/,
# serve/ and train/ are out of scope: argmax over logits is that code's
# bread and butter, not a protocol selection.
DEFAULT_SCOPE = (
    "src/repro_torch/core",
    "src/repro_torch/db",
    "src/repro_torch/kernels",
    "src/repro_torch/analysis",
)

# identifier tokens that mark an operand as timestamp-carrying for W02
_TS_TOKENS = {"ts", "cts", "rts", "tr", "vec", "vecs", "times", "stamp",
              "stamps", "timestamp", "timestamps", "tsvec"}
_WIDE_DTYPES = re.compile(r"(u?int64|float64|uint64|long|double)$")
_NARROW_INT = re.compile(r"(u?int8|u?int16|u?int32)$")
# names whose attribute calls are the function form (the operand is the
# first argument, not the receiver)
_MODULES = {"torch", "jnp", "np", "numpy", "jax", "F"}
# W06: what a scatter is, and what keeps an index an index
_INDEX_SCATTERS = {"scatter_", "scatter_add_", "scatter_reduce_",
                   "index_add_", "index_copy_", "index_fill_", "scatter",
                   "scatter_add", "scatter_reduce", "index_add",
                   "index_copy", "index_fill"}
_PUT_SCATTERS = {"index_put_", "index_put"}
_INDEX_METHODS = {"to", "long", "int", "reshape", "view", "expand",
                  "expand_as", "flatten", "squeeze", "unsqueeze",
                  "contiguous", "clone", "repeat", "detach"}


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _callee_attr(call: ast.Call) -> Optional[str]:
    """Last component of the callee (``sum`` for both torch.sum and
    x.sum)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _operand(call: ast.Call) -> Optional[ast.AST]:
    """The tensor a reduction reads: the receiver of a method call
    (``x.sum(-1)``), else the first argument (``torch.sum(x)``,
    ``sum(x)``)."""
    f = call.func
    if isinstance(f, ast.Attribute) and _dotted(f.value) not in _MODULES:
        return f.value
    return call.args[0] if call.args else None


def _identifiers(node: ast.AST) -> Iterable[str]:
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            yield n.attr


def _is_ts_like(node: ast.AST) -> bool:
    for ident in _identifiers(node):
        low = ident.lower()
        if "timestamp" in low:
            return True
        if any(tok in _TS_TOKENS for tok in low.split("_")):
            return True
    return False


def _dtype_matches(node: ast.AST, pattern) -> bool:
    d = _dotted(node)
    if d is not None and pattern.search(d):
        return True
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and pattern.search(node.value) is not None)


def _is_wide_dtype(node: ast.AST) -> bool:
    return _dtype_matches(node, _WIDE_DTYPES)


def _dtype_arg(call: ast.Call) -> Optional[ast.AST]:
    """The dtype of a ``.to(...)``/``.astype(...)`` call: its first
    argument or its ``dtype=`` keyword."""
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    return call.args[0] if call.args else None


def _const_int(node: ast.AST) -> Optional[int]:
    """Integer value of a literal, seeing through uint32(...)-style
    wrappers."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Call) and node.args:
        name = _callee_attr(node)
        if name in {"uint32", "int32", "uint64", "int64", "uint16", "asarray",
                    "array", "tensor", "as_tensor"}:
            return _const_int(node.args[0])
    return None


def _w02_operand_safe(node: ast.AST) -> bool:
    """True when the summand is provably exact: widened, digit-split, or
    boolean-derived. An IfExp is safe only if *every* branch is."""
    if isinstance(node, ast.IfExp):
        return (_w02_operand_safe(node.body)
                and _w02_operand_safe(node.orelse))
    if isinstance(node, ast.Compare):
        return True                     # boolean summand: counts, not sums
    if isinstance(node, ast.Call):
        name = _callee_attr(node)
        if name in {"astype", "to"}:
            dt = _dtype_arg(node)
            return dt is not None and _is_wide_dtype(dt)
        if name in {"uint64", "int64", "float64", "u64", "long", "double"}:
            return True
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.BitAnd):
            for side in (node.left, node.right):
                v = _const_int(side)
                if v is not None and v <= 0xFFFF:
                    return True         # low-digit extraction
        if isinstance(node.op, ast.RShift):
            v = _const_int(node.right)
            if v is not None and v >= 16:
                return True             # high-digit extraction
    return False


def _is_boolean(node: ast.AST) -> bool:
    """A syntactically boolean tensor: a comparison, a negation of one, or
    an elementwise and/or of such."""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                    (ast.Not, ast.Invert)):
        return _is_boolean(node.operand)
    if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                  (ast.BitAnd, ast.BitOr)):
        return _is_boolean(node.left) and _is_boolean(node.right)
    return False


def _w03_operand_safe(node: ast.AST) -> bool:
    """Comparisons and not-masks are boolean; a where() call is masked; a
    boolean widened to a narrow integer (torch has no argmax over bool)
    stays boolean."""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return True
    if isinstance(node, ast.Call):
        name = _callee_attr(node)
        if name == "where":
            return True
        if name in {"to", "astype"} and isinstance(node.func, ast.Attribute):
            dt = _dtype_arg(node)
            return (dt is not None and _dtype_matches(dt, _NARROW_INT)
                    and (_is_boolean(node.func.value)
                         or _w03_operand_safe(node.func.value)))
    return False


def _index_parts(node: ast.AST) -> List[ast.AST]:
    """The index expressions of a subscript or an ``index_put_`` tuple."""
    if isinstance(node, (ast.Tuple, ast.List)):
        return list(node.elts)
    return [node]


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self._gathered: List[Set[str]] = [set()]   # W06 taint, per scope

    def _add(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            rule=rule, level="ast", file=self.path,
            line=getattr(node, "lineno", 0), msg=msg))

    # ---- W06 taint: names holding a _u32.gidx index ------------------------
    def _from_gidx(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self._gathered[-1]
        if isinstance(node, ast.Call):
            name = _callee_attr(node)
            if name == "gidx":
                return True
            return (name in _INDEX_METHODS
                    and isinstance(node.func, ast.Attribute)
                    and self._from_gidx(node.func.value))
        if isinstance(node, ast.Subscript):
            return self._from_gidx(node.value)
        return False

    def _bind(self, target: ast.AST, value: Optional[ast.AST]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            vals = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts)
                    else [None] * len(target.elts))
            for t, v in zip(target.elts, vals):
                self._bind(t, v)
        elif isinstance(target, ast.Name):
            if value is not None and self._from_gidx(value):
                self._gathered[-1].add(target.id)
            else:
                self._gathered[-1].discard(target.id)

    def _check_scatter_index(self, idx: ast.AST, node: ast.AST,
                             what: str) -> None:
        if any(self._from_gidx(p) for p in _index_parts(idx)):
            self._add("W06", node,
                      f"{what} through an index made by _u32.gidx — a "
                      "clamped gather index; an out-of-range lane writes "
                      "row R-1 where JAX's scatter drops it (use _u32.sidx "
                      "and a sink row, or rows_of the lane mask)")

    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                self._check_scatter_index(t.slice, node,
                                          "subscript assignment")
                self.visit(t)
            else:
                self._bind(t, node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        if isinstance(node.target, ast.Subscript):
            self._check_scatter_index(node.target.slice, node,
                                      "subscript assignment")
        self.visit(node.target)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._bind(node.target, node.value)

    # ---- W01: a function that arbitrates must release ---------------------
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        acquires = [
            n for n in ast.walk(node)
            if isinstance(n, ast.Call) and _callee_attr(n) == "arbitrate"]
        if acquires:
            releases = any(
                isinstance(n, ast.Call)
                and _callee_attr(n) in {"release", "release_abandoned_locks"}
                for n in ast.walk(node))
            if not releases:
                for acq in acquires:
                    self._add(
                        "W01", acq,
                        f"`{node.name}` CAS-acquires (cas.arbitrate) but "
                        "never calls a release — locks leak on the abort "
                        "path")
        self._gathered.append(set(self._gathered[-1]))
        self.generic_visit(node)
        self._gathered.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    # ---- W02/W03/W04/W06: call-site rules ---------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _callee_attr(node)
        if name in {"sum", "cumsum"}:
            summand = _operand(node)
            wide_kw = any(kw.arg == "dtype" and _is_wide_dtype(kw.value)
                          for kw in node.keywords)
            if (summand is not None and _is_ts_like(summand)
                    and not wide_kw and not _w02_operand_safe(summand)):
                self._add(
                    "W02", node,
                    f"`{name}` over a timestamp-carrying operand without "
                    "widening to int64 or an exact (hi, lo) base-2^16 "
                    "digit split — wraps past 2^32")
        elif name in {"argmin", "argmax"}:
            operand = _operand(node)
            if operand is not None and not _w03_operand_safe(operand):
                self._add(
                    "W03", node,
                    f"`{name}` over a possibly sentinel-carrying array — "
                    "mask with where()/a boolean first, or annotate the "
                    "operand as sentinel-free")
        elif name == "append_intent":
            padded = any(isinstance(a, ast.Starred)
                         and isinstance(a.value, ast.Call)
                         and _callee_attr(a.value) == "pad_writes"
                         for a in node.args)
            if not padded:
                self._add(
                    "W04", node,
                    "append_intent call site does not run its write-set "
                    "through *wal.pad_writes(...) — widths can silently "
                    "mismatch the journal's declared shape")
        elif name in _INDEX_SCATTERS and isinstance(node.func,
                                                    ast.Attribute):
            idx = node.args[1] if len(node.args) > 1 else next(
                (kw.value for kw in node.keywords if kw.arg == "index"),
                None)
            if idx is not None:
                self._check_scatter_index(idx, node, f"`{name}`")
        elif name in _PUT_SCATTERS and node.args:
            self._check_scatter_index(node.args[0], node, f"`{name}`")
        self.generic_visit(node)

    # ---- W05: raw ring positions vs Journal.used --------------------------
    def visit_Compare(self, node: ast.Compare) -> None:
        sides = [node.left] + list(node.comparators)

        def has_arange(n: ast.AST) -> bool:
            return any(isinstance(x, ast.Call)
                       and _callee_attr(x) == "arange"
                       for x in ast.walk(n))

        def has_used(n: ast.AST) -> bool:
            return any(isinstance(x, ast.Attribute) and x.attr == "used"
                       for x in ast.walk(n))

        if (any(has_arange(s) for s in sides)
                and any(has_used(s) for s in sides)):
            self._add(
                "W05", node,
                "raw ring positions (arange) compared against Journal.used "
                "— only correct before the ring's first wrap; use "
                "wal._live_window")
        self.generic_visit(node)


def lint_source(text: str, path: str) -> List[Finding]:
    """Lint one source text (``path`` names it in the findings);
    suppressions applied."""
    tree = ast.parse(text, filename=path)
    v = _Visitor(path)
    v.visit(tree)
    apply_suppressions(v.findings, lambda _f: text)
    return v.findings


def lint_file(path) -> List[Finding]:
    path = Path(path)
    return lint_source(path.read_text(), str(path))


def lint_paths(paths) -> List[Finding]:
    """Lint files and/or directories (recursively); returns all findings,
    suppressed ones included (filter on ``.suppressed``)."""
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    out: List[Finding] = []
    for f in files:
        out.extend(lint_file(f))
    return out
