"""``python -m repro_torch.analysis`` — run the three analysis levels over
the port and write a report.

Levels (DESIGN.md §7): the AST lint (W01-W06), the dispatch-level audit of
the commit/replay/GC entry points (A1-A4) on ``--device``, and the kernel
level (K3 on the design points' launch arithmetic, K5 over the ops/ref
pairs; with ``--device cuda`` also K3 on the built functions and the run
checks of :mod:`.sanitize`). Exit status (with ``--strict``): non-zero iff
any *unsuppressed* finding exists at any level, or an entry point or
kernel could not be audited. The JSON report (``ANALYSIS_torch_report.json``
by default; :mod:`.report` checks its schema) is machine-readable;
``--sarif`` also writes SARIF 2.1.0; the summary goes to stdout.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.report import KIND, SCHEMA_VERSION


def to_sarif(report: dict) -> dict:
    """Render the analysis report as SARIF 2.1.0 (GitHub code scanning).

    Suppressed findings are carried with a SARIF ``suppressions`` entry
    (so the annotation shows as reviewed, not as an open alert); active
    findings map to level "error", the severity ``--strict`` gates on.
    """
    rules = [{
        "id": rid,
        "name": meta["title"].title().replace(" ", "").replace("-", ""),
        "shortDescription": {"text": meta["title"]},
    } for rid, meta in sorted(report["rules"].items())]
    index = {r["id"]: i for i, r in enumerate(rules)}
    results = []
    for f in report["findings"]:
        res = {
            "ruleId": f["rule"],
            "ruleIndex": index.get(f["rule"], -1),
            "level": "note" if f["suppressed"] else "error",
            "message": {"text": f"[{f['level']}] {f['msg']}"},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f["file"],
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(f["line"], 1)},
                },
            }],
        }
        if f["suppressed"]:
            res["suppressions"] = [{"kind": "inSource",
                                    "justification": f["reason"]}]
        results.append(res)
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "repro_torch.analysis",
                "informationUri":
                    "https://example.invalid/repro/DESIGN.md#7",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Protocol analysis of the PyTorch port: AST lint "
                    "(W01-W06) + dispatch-level audit of the commit/"
                    "replay/GC entry points (A1-A4) + kernel level (K3, "
                    "K5; on the card also the built functions' resources "
                    "and the kernels' run checks).")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the port's "
                         "standard scope)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on any active finding or audit "
                         "error")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the graph audit runs its entry points "
                         "(cuda also runs the card's kernel checks)")
    ap.add_argument("--out", default="ANALYSIS_torch_report.json",
                    help="JSON report path ('' disables)")
    ap.add_argument("--sarif", default="",
                    help="also write the findings as SARIF 2.1.0 to this "
                         "path")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST level")
    ap.add_argument("--no-graph", action="store_true",
                    help="skip the dispatch-level audit")
    ap.add_argument("--no-kernel", action="store_true",
                    help="skip the kernel level")
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parents[3]
    findings, entry_reports, kernel_reports = [], [], []

    if not args.no_lint:
        from repro_torch.analysis import lint
        paths = args.paths or [root / p for p in lint.DEFAULT_SCOPE]
        findings += lint.lint_paths(paths)

    if not args.no_graph:
        from repro_torch.analysis import graph_audit
        gfindings, entry_reports = graph_audit.audit_tree(args.device)
        findings += gfindings

    if not args.no_kernel:
        from repro_torch.analysis import kernel_audit
        kfindings, kernel_reports = kernel_audit.audit_kernels()
        findings += kfindings
        if args.device == "cuda":
            import torch

            from repro_torch.analysis import sanitize
            from repro_torch.kernels import _build
            _build.build_all()
            findings += kernel_audit.card_k3(
                torch.cuda.get_device_properties(0)
                .shared_memory_per_block_optin)[0]
            findings += sanitize.run_all()[0]

    def rel(p: str) -> str:
        try:
            return str(Path(p).resolve().relative_to(root))
        except ValueError:
            return p

    for f in findings:
        f.file = rel(f.file)

    active = [f for f in findings if not f.suppressed]
    errors = [r for r in entry_reports + kernel_reports if r.status != "ok"]
    ok = not active and not errors

    from repro_torch.analysis.rules import RULES
    report = {
        "kind": KIND,
        "schema_version": SCHEMA_VERSION,
        "ok": ok,
        "strict": args.strict,
        "device": args.device,
        "rules": {w: {"graph_id": r.aid, "title": r.title}
                  for w, r in RULES.items()},
        "entrypoints": [r.to_json() for r in entry_reports],
        "kernels": [r.to_json() for r in kernel_reports],
        "findings": [f.to_json() for f in findings],
        "counts": {"total": len(findings), "active": len(active),
                   "suppressed": len(findings) - len(active)},
    }
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
    if args.sarif:
        Path(args.sarif).write_text(
            json.dumps(to_sarif(report), indent=2) + "\n")

    for r in entry_reports:
        mark = "ok " if r.status == "ok" else "ERR"
        extra = f" ({r.detail})" if r.detail else ""
        tags = ", ".join(f"{t} ← {'+'.join(v['from']) or '-'}"
                         for t, v in r.tags.items())
        print(f"[{mark}] {r.name}: {r.n_ops} ops, {r.n_findings} active "
              f"findings{extra}" + (f"; tags {tags}" if tags else ""))
    for r in kernel_reports:
        mark = "ok " if r.status == "ok" else "ERR"
        extra = f" ({r.detail})" if r.detail else ""
        print(f"[{mark}] kernel {r.name}: {r.n_launches} design points, "
              f"{r.smem_bytes} B dynamic shared memory at most / "
              f"{r.smem_budget} B, {r.n_findings} active findings{extra}")
    for f in findings:
        print(f.render())
    print(f"analysis: {len(active)} active / "
          f"{len(findings) - len(active)} suppressed findings, "
          f"{len(errors)} audit errors")
    if args.strict and not ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
