"""Rule catalog, findings, and suppression syntax of ``repro_torch.analysis``.

The analyzer runs at three levels (DESIGN.md §7): a dispatch-level audit
of the protocol entry points over real tensors (rule ids A1-A4,
:mod:`.graph_audit`), an AST lint over the port's source (W01-W06,
:mod:`.lint`), and the kernel level (K1-K5, :mod:`.kernel_audit` and
:mod:`.sanitize`). W01-W04 mirror A1-A4: the A-form sees through a run
(actual dataflow, actual dtypes), the W-form catches the same bug class at
its call-site spelling. W05 and W06 are AST-only; W06 is the port's own
rule, for F1's fault (a clamped gather index that reached a scatter).

The K rules descend into Pallas kernel bodies in the JAX package. The
port's kernels are CUDA C++, which nothing here parses, so K1, K2 and K4
are held by run checks on the card, each named in its description; K3 is
checked on the kernels' launch arithmetic here and on the built code on
the card, and K5 is a structural check over ``kernels/*/ops.py`` and
``ref.py``.

Suppression syntax
------------------
A finding is suppressed by a comment on the flagged line or the line
directly above it::

    # analysis: safe(W03): boolean mask operand — no sentinels
    first = ok.to(torch.int8).argmax(dim=1)

The rule list takes W-, A- or K-form ids (comma-separated for several
rules); the reason is **mandatory**: ``safe(W03)`` without one does not
suppress. The syntax is the JAX package's, so one comment reads the same
in both packages, and every level honors it: the graph audit maps each op
back to its source line through the Python stack.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Set, Tuple


@dataclasses.dataclass(frozen=True)
class Rule:
    wid: str                 # AST-level id (W01..) or kernel id (K1..)
    aid: Optional[str]       # graph-level mirror (A1..), None = no mirror
    title: str
    description: str


RULES: Dict[str, Rule] = {
    "W01": Rule(
        "W01", "A1", "unpaired CAS lock acquisition",
        "Every CAS-acquire site's grant mask must provably flow into the "
        "abort-path release mask AND the commit decision (whose install + "
        "visibility write consumes the lock). A grant that reaches neither "
        "is a lock leaked on some outcome path. AST form: a function body "
        "that calls cas.arbitrate must also call a release. Graph form: "
        "the lock.granted tag's storage taint reaches the lock.released "
        "and commit.committed tags."),
    "W02": Rule(
        "W02", "A2", "overflow-unsafe timestamp reduction",
        "No integer sum/cumsum over uint32 timestamp words without widening "
        "to int64 (_u32.u64, .to(torch.int64), sum(dtype=torch.int64)) or "
        "the exact (hi, lo) base-2^16 digit split of wal._order_keys; the "
        "graph form also refuses amin/amax over int32 words that still "
        "carry the timestamp label. A wrapped sum silently inverts the "
        "replay dominance order."),
    "W03": Rule(
        "W03", "A3", "sentinel-blind argmin/argmax",
        "No argmin/argmax over an array that can carry -1/0xFFFFFFFF "
        "sentinel encodings unless the operand is boolean (a bool tensor "
        "widened with .to(torch.int8)) or masked by torch.where first. A "
        "sentinel that sorts below every live value hijacks the "
        "selection."),
    "W04": Rule(
        "W04", "A4", "journal-width mismatch at append site",
        "Every append_intent call site must feed vectors of the journal's "
        "declared width: the write-set through wal.pad_writes, the "
        "timestamp vector sliced to the journal's n_slots. The A-form is "
        "append_intent's own width guard (it raises '[A4]'), which the "
        "graph audit turns into a finding; the W-form requires the "
        "*wal.pad_writes(...) spelling."),
    "W05": Rule(
        "W05", None, "raw ring-position iteration over a Journal",
        "Replay-side code must not compare raw ring positions "
        "(arange(capacity)) against Journal.used: position < used is only "
        "correct before the first wrap. Use wal._live_window."),
    "W06": Rule(
        "W06", None, "scatter through a gather index",
        "An index made by _u32.gidx (wrapped once, then CLAMPED: JAX's "
        "gather semantics) must never reach a scatter (index_put_, "
        "scatter_, scatter_add_, scatter_reduce_, index_add_, index_copy_, "
        "index_fill_, or a subscript assignment), directly or through a "
        "name assigned from it. JAX's scatter DROPS an out-of-range lane; "
        "the clamped index writes it into row R-1 instead. Use _u32.sidx "
        "and a sink row, or rows_of of the lane mask — fault F1."),
    # ---- kernel-level rules (kernel_audit, sanitize) ----------------------
    "K1": Rule(
        "K1", None, "out-of-bounds or uninitialised access inside a kernel",
        "Every dynamic index inside a kernel must stay within its buffer, "
        "and no kernel may read memory its launch never wrote. The JAX "
        "package proves the first over Pallas jaxprs; CUDA C++ has no "
        "jaxpr. The port's stand-in is a run check on the card "
        "(analysis/sanitize.py): each kernel launched on adversarial "
        "inputs (slots out of range, padding lanes, unmapped pages, "
        "kv_len = 0, rows without keys) with every buffer it touches "
        "between canary margins, which must come back intact; the "
        "buffers its wrapper allocates poisoned with 0x00 and 0xFF in "
        "turn, and the two runs bit-identical; the result equal to the "
        "plain version. It sees writes out of range near a buffer and "
        "reads of unwritten memory that change a result, not reads out of "
        "range; compute-sanitizer's memcheck and initcheck would see more "
        "but refuse the H100 the port is measured on ('Device not "
        "supported')."),
    "K2": Rule(
        "K2", None, "shared-memory and aliasing hazard inside a kernel",
        "A kernel must read every operand before its first in-place write "
        "to the same buffer, and its threads must not race on shared "
        "memory. The JAX package checks input_output_aliases over Pallas "
        "jaxprs. The port's stand-in is a run check on the card "
        "(analysis/sanitize.py): two launches on the same inputs and the "
        "same poison must give the same bits, and the result must equal "
        "the plain version. A race that changes no result passes; "
        "compute-sanitizer's racecheck refuses the H100 the port is "
        "measured on."),
    "K3": Rule(
        "K3", None, "per-block shared-memory or register budget exceeded",
        "At every design point (the shapes chip_smoke.py launches) a "
        "block's dynamic shared memory, from the kernel's own smem_bytes "
        "or tc_smem_bytes, must fit _cuda.MAX_SMEM; on the card the "
        "built functions' static plus dynamic shared memory must fit "
        "shared_memory_per_block_optin (which must equal MAX_SMEM), and "
        "registers times threads a block must fit the 65,536 registers of "
        "an SM (cuobjdump --dump-resource-usage)."),
    "K4": Rule(
        "K4", None, "CAS grant does not reach the fused install",
        "Inside the lock-carrying kernel the arbitration result must "
        "flow into every in-place header write. The JAX package proves "
        "it with a taint walk over the Pallas jaxpr; over CUDA C++ the "
        "port has no stand-in beyond the lock-step rule: chip_smoke.py "
        "phases 3-5 hold fused_commit bit-identical to its plain "
        "version (si.commit_write_sets, whose graph audit is A1) on real "
        "and adversarial grants."),
    "K5": Rule(
        "K5", None, "kernel entry point without lock-step ref parity",
        "Each kernel of _build.KERNELS must have its ops entry point, a "
        "<name>_ref twin in ref.py with the same positional parameters "
        "(the twin's keyword-only parameters a subset of the op's), and "
        "the twin referenced by a cross-package tests/test_torch_*.py "
        "(which imports JAX) and by tests/test_torch_gpu.py. A kernel "
        "without its oracle in lock step is a protocol change, not an "
        "access path (DESIGN.md §8)."),
}

_ALIASES: Dict[str, str] = {r.aid: w for w, r in RULES.items() if r.aid}


def canonical(rule_id: str) -> str:
    """Normalize a W- or A-form rule id to its W-form catalog key."""
    rid = rule_id.strip().upper()
    return _ALIASES.get(rid, rid)


@dataclasses.dataclass
class Finding:
    rule: str          # canonical W-form (or K-form) id
    level: str         # "graph" | "ast" | "kernel"
    file: str
    line: int
    msg: str
    suppressed: bool = False
    reason: str = ""   # the suppression's stated reason, when suppressed

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = f" [suppressed: {self.reason}]" if self.suppressed else ""
        rid = self.rule
        rule = RULES.get(self.rule)
        if self.level == "graph" and rule is not None and rule.aid:
            rid = f"{rule.aid}/{self.rule}"
        return (f"{self.file}:{self.line}: {rid}({self.level}) "
                f"{self.msg}{tag}")


# reason is mandatory: the trailing `:\s*\S` refuses a bare safe(W03)
_SUPPRESS_RE = re.compile(
    r"#\s*analysis:\s*safe\(\s*([AWKawk][0-9]+(?:\s*,\s*[AWKawk][0-9]+)*\s*)\)"
    r"\s*:\s*(\S.*)")

Suppressions = Dict[int, Tuple[Set[str], str]]


def scan_suppressions(text: str) -> Suppressions:
    """Map line number -> (canonical rule ids, reason) for one source file."""
    out: Suppressions = {}
    for i, line in enumerate(text.splitlines(), 1):
        m = _SUPPRESS_RE.search(line)
        if m:
            ids = {canonical(x) for x in m.group(1).split(",")}
            out[i] = (ids, m.group(2).strip())
    return out


def suppression_for(supp: Suppressions, line: int,
                    rule: str) -> Optional[str]:
    """The reason suppressing ``rule`` at ``line`` (same or previous line),
    or None."""
    rid = canonical(rule)
    for ln in (line, line - 1):
        ent = supp.get(ln)
        if ent and rid in ent[0]:
            return ent[1]
    return None


def load_text(file: str) -> Optional[str]:
    """A source file's text, None when it is not a readable file."""
    try:
        with open(file) as f:
            return f.read()
    except OSError:
        return None


def apply_suppressions(findings, load=load_text) -> None:
    """Mark findings suppressed in place. ``load(file) -> str | None``
    supplies source text (None when the file is unreadable)."""
    cache: Dict[str, Optional[Suppressions]] = {}
    for f in findings:
        if f.file not in cache:
            text = load(f.file)
            cache[f.file] = None if text is None else scan_suppressions(text)
        supp = cache[f.file]
        if supp is None or f.line <= 0:
            continue
        reason = suppression_for(supp, f.line, f.rule)
        if reason is not None:
            f.suppressed, f.reason = True, reason
