"""Level 3: the kernel-level checks over the port's CUDA kernels.

The JAX package's kernel audit walks Pallas jaxprs (K1, K2, K4) and sums
staged block shapes against VMEM (K3). The port's kernels are CUDA C++,
with nothing to walk, so this module keeps the two checks that still have
an object, and :mod:`.sanitize` holds the run checks that stand in for the
rest (``rules.RULES`` says which stands in for what):

* **K5 (ref parity)**: pure AST. Each kernel of ``_build.KERNELS`` needs
  its ``ops`` entry point, a ``<name>_ref`` twin in ``ref.py`` with the
  same positional parameters (the twin's keyword-only ones a subset of the
  op's), and the twin referenced by a cross-package
  ``tests/test_torch_*.py`` (one that imports the JAX package) and by
  ``tests/test_torch_gpu.py``. The entry points come from
  ``_build.KERNELS``, not from every public ``def``: an ``ops.py`` also
  holds launch helpers (``prepare``, ``smem_bytes`` ...).
* **K3 (shared memory and registers)**: every design point names the
  built function, its threads a block and its dynamic shared memory, as
  the kernel's wrapper computes them at its launch (each ops module's
  ``launch_points``). Here (:func:`design_points`) the points are the
  wrappers' launches at the widths of every architecture of
  ``repro_torch.configs`` and at a TPC-C round, and the dynamic bytes must
  fit ``_cuda.MAX_SMEM``. On the card (:func:`card_k3`) the points are
  what the wrappers recorded as they launched (:func:`launched`), or the
  design points, and each function's static plus dynamic bytes must fit
  the device's
  ``shared_memory_per_block_optin`` (which must equal ``MAX_SMEM``) and
  its registers, rounded up to the allocation unit of 8, times its threads
  must fit the 65,536 registers of an SM, from ``cuobjdump
  --dump-resource-usage`` of the built library.

Findings honor ``# analysis: safe(K5): reason`` comments.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.rules import Finding, apply_suppressions, \
    load_text
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.db import tpcc
from repro_torch.kernels import _build, _cuda
from repro_torch.kernels.commit import ops as co
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.hash_probe import ops as hp
from repro_torch.kernels.mamba_scan import ops as ms
from repro_torch.kernels.moe_gmm import ops as mg
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models.recurrent import Mamba
from repro_torch.serve.engine import EngineConfig

_REPO_ROOT = Path(__file__).resolve().parents[3]
# the ops package of a kernel whose name is not its package's
PACKAGE_OF = {"batched_probe": "hash_probe", "fused_commit": "commit"}
REGS_PER_SM = 65_536
_REG_UNIT = 8      # registers are allocated per thread in units of 8


# ==========================================================================
# K5: ops/ref structural parity (pure AST)
# ==========================================================================

def _funcs(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _positional_names(fn: ast.FunctionDef) -> List[str]:
    return [a.arg for a in list(fn.args.posonlyargs) + list(fn.args.args)]


def _kwonly_names(fn: ast.FunctionDef) -> Set[str]:
    return {a.arg for a in fn.args.kwonlyargs}


def check_ref_parity_sources(ops_text: str, ops_file: str,
                             ref_text: Optional[str], names: Sequence[str],
                             cross_tests_text: str,
                             gpu_tests_text: str) -> List[Finding]:
    """K5 over one ops.py source for the kernel entry points ``names`` (the
    corpus tests' entry hook). ``ref_text`` is the package's ref.py source
    (None = missing file); ``cross_tests_text`` the cross-package tests'
    source, ``gpu_tests_text`` the card tests', each scanned for the
    ``<name>_ref`` registration. No suppressions applied."""
    findings: List[Finding] = []

    def add(node, msg):
        findings.append(Finding(rule="K5", level="kernel", file=ops_file,
                                line=getattr(node, "lineno", 0), msg=msg))

    ops = _funcs(ast.parse(ops_text, filename=ops_file))
    refs = {} if ref_text is None else _funcs(ast.parse(ref_text))
    for name in names:
        fn = ops.get(name)
        if fn is None:
            add(None, f"kernel `{name}` has no entry point `{name}` in "
                      "ops.py — the three-file shape (DESIGN.md §8) lost "
                      "its wrapper")
            continue
        ref_name = f"{name}_ref"
        ref = refs.get(ref_name)
        if ref is None:
            add(fn, f"entry point `{name}` has no lock-step `{ref_name}` "
                    "in ref.py — a kernel without its plain version cannot "
                    "be differentially proven")
            continue
        want, got = _positional_names(fn), _positional_names(ref)
        if want != got:
            add(fn, f"`{ref_name}` positional signature {got} does not "
                    f"match `{name}`'s {want} — ops and ref have drifted "
                    "out of lock step")
        extra = _kwonly_names(ref) - _kwonly_names(fn)
        if extra:
            add(fn, f"`{ref_name}` takes keyword-only {sorted(extra)} that "
                    f"`{name}` does not — the plain version exercises a "
                    "contract the kernel cannot")
        for text, where in ((cross_tests_text, "a cross-package "
                             "tests/test_torch_*.py"),
                            (gpu_tests_text, "tests/test_torch_gpu.py")):
            if not re.search(rf"\b{ref_name}\b", text):
                add(fn, f"`{ref_name}` is not referenced by {where} — no "
                        "registered differential test keeps the pair in "
                        "lock step")
    return findings


def _imports_reference(text: str) -> bool:
    tree = ast.parse(text)
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom)
                else [])
        if any(m.split(".")[0] in ("jax", "repro") for m in mods):
            return True
    return False


def check_ref_parity() -> List[Finding]:
    """K5 over the kernels of ``_build.KERNELS``; suppressions applied."""
    kdir = _REPO_ROOT / "src" / "repro_torch" / "kernels"
    tests = sorted((_REPO_ROOT / "tests").glob("test_torch_*.py"))
    texts = {p.name: p.read_text() for p in tests}
    cross = "\n".join(t for t in texts.values() if _imports_reference(t))
    gpu = texts.get("test_torch_gpu.py", "")
    by_pkg: Dict[str, List[str]] = {}
    for n in _build.KERNELS:
        by_pkg.setdefault(PACKAGE_OF.get(n, n), []).append(n)
    findings: List[Finding] = []
    for pkg, pkg_names in sorted(by_pkg.items()):
        ops = kdir / pkg / "ops.py"
        ops_text = load_text(str(ops))
        if ops_text is None:
            findings.append(Finding(
                rule="K5", level="kernel", file=str(kdir / pkg), line=0,
                msg=f"kernel package `{pkg}` has no ops.py — every kernel "
                    "directory follows the three-file shape (DESIGN.md "
                    "§8)"))
            continue
        findings += check_ref_parity_sources(
            ops_text, str(ops), load_text(str(kdir / pkg / "ref.py")),
            pkg_names, cross, gpu)
    apply_suppressions(findings)
    return findings


# ==========================================================================
# K3: the design points and their shared memory
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One launch of a built kernel function at a design point."""
    label: str        # the design point: the widths, or its launch count
    library: str      # the kernel of _build.KERNELS that holds it
    function: str     # its name as cu++filt gives it, without namespace
    threads: int      # threads a block
    smem: int         # dynamic shared memory a block, bytes


# the decode shape whose context sizes the paged launch's partitions
DECODE_SHAPE = "decode_32k"


def _arch_points(arch: str) -> List[KernelSpec]:
    """The launches of the LM kernels' wrappers at an architecture's own
    widths, in bfloat16 as it serves: attention (head dims the kernels
    take), the decode of :data:`DECODE_SHAPE`'s context in the serving
    engine's pages, the experts and the selective scan (a Mamba layer's
    widths are its class's defaults)."""
    cfg = get_arch(arch)
    kinds = {s.kind for s in cfg.unit()}
    D, g = cfg.d_head, cfg.n_heads // cfg.n_kv_heads
    out = []

    def add(kernel, label, points):
        out.extend(KernelSpec(f"{arch}: {label}", kernel, *p)
                   for p in points)
    if "attn" in kinds and D in fa.HEAD_DIMS:
        add("flash_attention", f"attention (D = {D})", fa.tc_points(D))
    if "attn" in kinds and D in pa.HEAD_DIMS:
        ps = EngineConfig.page_size
        add("paged_attention", f"{DECODE_SHAPE} (D = {D}, g = {g})",
            pa.launch_points(D, g, 2, SHAPES[DECODE_SHAPE].seq_len // ps,
                             ps))
    if cfg.n_experts:
        add("moe_gmm", f"experts ({cfg.activation})",
            mg.launch_points(cfg.activation, True))
    if "mamba" in kinds:
        kw = Mamba.__init__.__kwdefaults__
        Di, N = kw["expand"] * cfg.d_model, kw["d_state"]
        bd = ms.block_channels(None, Di, 2)
        chunk = ms.chunk_steps(ms.prepare.__kwdefaults__["chunk"], N, bd, 2)
        add("mamba_scan", f"selective scan (Di = {Di}, N = {N})",
            ms.launch_points(N, bd, chunk, 2))
    return out


def design_points() -> List[KernelSpec]:
    """The design points K3 checks here: the TPC-C kernels at a new-order
    round of ``tpcc.TPCCConfig()`` (its threads, each writing a district
    and ``MAX_OL`` stock rows), and the LM kernels at the widths of every
    architecture of ``repro_torch.configs``."""
    Q = tpcc.TPCCConfig().n_threads * (1 + tpcc.MAX_OL)
    label = f"TPC-C new-order round, Q = {Q}"
    points = [KernelSpec(label, n, *p) for n in ("batched_probe",
                                                  "hash_probe")
              for p in hp.launch_points(n)]
    points += [KernelSpec(label, "fused_commit", *p)
               for p in co.launch_points(Q)]
    return points + [p for a in ARCH_IDS for p in _arch_points(a)]


def launched(wrappers: Dict[str, object]) -> List[KernelSpec]:
    """The design points that ran in this process: each ``(function,
    threads, dynamic shared bytes)`` in the ``launched`` of ``wrappers``
    (kernel name → its wrapper), labelled by how often it ran."""
    return [KernelSpec(f"launched {n} times", name, *point)
            for name, w in wrappers.items()
            for point, n in sorted(w.launched.items())]


@dataclasses.dataclass
class KernelReport:
    name: str
    status: str            # "ok" | "error"
    detail: str = ""
    n_launches: int = 0    # design points of this kernel
    smem_bytes: int = 0    # the largest dynamic shared memory of a block
    smem_budget: int = 0
    n_findings: int = 0    # active (unsuppressed)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def check_smem(points: Iterable[KernelSpec]) -> List[Finding]:
    """K3 here: each design point's dynamic shared memory within
    ``_cuda.MAX_SMEM``."""
    return [Finding(
        rule="K3", level="kernel", file=p.library, line=0,
        msg=f"[{p.label}] `{p.function}` asks {p.smem} bytes of dynamic "
            f"shared memory a block, over the {_cuda.MAX_SMEM} bytes of "
            "_cuda.MAX_SMEM — the launch fails")
        for p in points if p.smem > _cuda.MAX_SMEM]


def audit_kernels(points: Optional[Sequence[KernelSpec]] = None,
                  ) -> Tuple[List[Finding], List[KernelReport]]:
    """K3 on every design point (default :func:`design_points`), grouped
    by kernel, then K5 over ``_build.KERNELS``."""
    try:
        points = list(design_points() if points is None else points)
    except Exception as e:   # a design point that cannot be sized is a bug
        return [], [KernelReport("design_points", "error",
                                 f"{type(e).__name__}: {e}")]
    findings: List[Finding] = []
    reports: List[KernelReport] = []
    for name in dict.fromkeys(p.library for p in points):
        mine = [p for p in points if p.library == name]
        fs = check_smem(mine)
        findings += fs
        reports.append(KernelReport(
            name, "ok", n_launches=len(mine),
            smem_bytes=max(p.smem for p in mine),
            smem_budget=_cuda.MAX_SMEM, n_findings=len(fs)))
    return findings + check_ref_parity(), reports


# ==========================================================================
# K3 on the card: the built functions' resources
# ==========================================================================

def toolkit_program(name: str) -> str:
    """A CUDA toolkit program beside ``nvcc``; raises when it is missing."""
    path = shutil.which(name, path=str(Path(_build.find_nvcc()).parent)) \
        or shutil.which(name)
    if path is None:
        raise RuntimeError(f"{name} not found beside nvcc or on PATH")
    return path


def _short(demangled: str) -> str:
    """``f<T, 8>`` of ``void (anonymous namespace)::f<T, (int)8>(args)``,
    as cu++filt writes a kernel's name."""
    s = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\(int\)|^void ", "",
               demangled.strip())
    depth = 0
    for i, c in enumerate(s):     # cut the parameter list at depth 0
        depth += c == "<"
        depth -= c == ">"
        if c == "(" and depth == 0:
            return s[:i].strip()
    return s


_FUNCTION = re.compile(r"^\s*Function (\S+):")
_USAGE = re.compile(r"REG:(\d+).*?SHARED:(\d+)")


def resource_usage(library: Path) -> Dict[str, Tuple[int, int]]:
    """``{function: (registers, static shared bytes)}`` of a built kernel
    library, from ``cuobjdump --dump-resource-usage``."""
    out = subprocess.run(
        [toolkit_program("cuobjdump"), "--dump-resource-usage",
         str(library)], capture_output=True, text=True, check=True).stdout
    rows, fn = {}, None
    for line in out.splitlines():
        m = _FUNCTION.match(line)
        if m:
            fn = m.group(1)
            continue
        m = _USAGE.search(line)
        if m and fn is not None:
            rows[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    names = subprocess.run(
        [toolkit_program("cu++filt")], input="\n".join(rows),
        capture_output=True, text=True, check=True).stdout.splitlines()
    return {_short(d): rows[m] for m, d in zip(rows, names)}


@dataclasses.dataclass
class CardRow:
    """One design point against the built function's resources."""
    spec: KernelSpec
    registers: int
    static_smem: int

    @property
    def smem(self) -> int:
        return self.static_smem + self.spec.smem

    @property
    def registers_a_block(self) -> int:
        regs = -(-self.registers // _REG_UNIT) * _REG_UNIT
        return regs * self.spec.threads


def card_k3(optin: int, points: Optional[Sequence[KernelSpec]] = None,
            usage: Optional[Dict[str, Dict[str, Tuple[int, int]]]] = None,
            ) -> Tuple[List[Finding], List[CardRow]]:
    """K3 on the card, over the built libraries (build them first):
    ``optin`` is the device's ``shared_memory_per_block_optin``.
    ``usage`` maps a kernel to :func:`resource_usage` of its library (read
    from the build when None). Returns the findings and a row a design
    point."""
    points = list(design_points() if points is None else points)
    findings: List[Finding] = []

    def add(p: Optional[KernelSpec], msg: str) -> None:
        findings.append(Finding(
            rule="K3", level="kernel", line=0, msg=msg,
            file=p.library if p is not None else "<device>"))

    if optin != _cuda.MAX_SMEM:
        add(None, f"the device's shared_memory_per_block_optin is {optin} "
                  f"bytes, not _cuda.MAX_SMEM = {_cuda.MAX_SMEM}: the "
                  "wrappers size their tiles for another card")
    usage = {} if usage is None else dict(usage)
    rows: List[CardRow] = []
    for p in points:
        if p.library not in usage:
            usage[p.library] = resource_usage(_build.library(p.library))
        got = usage[p.library].get(p.function)
        if got is None:
            add(p, f"[{p.label}] no built function `{p.function}` in "
                   f"{p.library}'s library (it has "
                   f"{sorted(usage[p.library])[:8]} ...)")
            continue
        row = CardRow(p, *got)
        rows.append(row)
        if row.smem > optin:
            add(p, f"[{p.label}] `{p.function}`: {row.static_smem} static "
                   f"+ {p.smem} dynamic bytes of shared memory a block, "
                   f"over the device's {optin}")
        if row.registers_a_block > REGS_PER_SM:
            add(p, f"[{p.label}] `{p.function}`: {row.registers} registers "
                   f"× {p.threads} threads = {row.registers_a_block}, over "
                   f"the {REGS_PER_SM} registers of an SM")
    return findings, rows
