"""Schema check of the ``ANALYSIS_torch_report.json`` document.

``python -m repro_torch.analysis`` writes the report; this module pins its
shape (the schema version, the rule catalog, the entry-point and kernel
reports, and every finding's rule id, level, location and mandatory
suppression reason), so that the format cannot rot silently. Pure stdlib,
and it reads nothing of the repo: it judges the document alone.

    python -m repro_torch.analysis.report [ANALYSIS_torch_report.json]
"""
from __future__ import annotations

import json
import re
import sys

KIND = "analysis_torch_report"
SCHEMA_VERSION = 1

RULE_ID = re.compile(r"^[WK][0-9]{1,2}$")
GRAPH_ID = re.compile(r"^A[0-9]{1,2}$")
LEVELS = ("ast", "graph", "kernel")

ENTRYPOINT_KEYS = {"name": str, "status": str, "detail": str, "n_ops": int,
                   "n_findings": int, "tags": dict}
KERNEL_KEYS = {"name": str, "status": str, "detail": str, "n_launches": int,
               "smem_bytes": int, "smem_budget": int, "n_findings": int}
FINDING_KEYS = {"rule": str, "level": str, "file": str, "line": int,
                "msg": str, "suppressed": bool, "reason": str}
COUNT_KEYS = {"total": int, "active": int, "suppressed": int}


class SchemaError(Exception):
    pass


def _check_fields(obj, spec: dict, where: str):
    if not isinstance(obj, dict):
        raise SchemaError(f"{where}: expected object, got "
                          f"{type(obj).__name__}")
    for key, typ in spec.items():
        if key not in obj:
            raise SchemaError(f"{where}: missing key {key!r}")
        val = obj[key]
        ok = (isinstance(val, bool) if typ is bool else
              isinstance(val, int) and not isinstance(val, bool)
              if typ is int else isinstance(val, typ))
        if not ok:
            raise SchemaError(f"{where}.{key}: expected {typ.__name__}, "
                              f"got {type(val).__name__} ({val!r})")


def check(doc: dict) -> None:
    """Raise :class:`SchemaError` unless ``doc`` is a well-formed report."""
    if doc.get("kind") != KIND:
        raise SchemaError(f"kind {doc.get('kind')!r} != {KIND!r}")
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise SchemaError(f"schema_version {doc.get('schema_version')!r} "
                          f"!= {SCHEMA_VERSION}")
    for key in ("ok", "strict"):
        if not isinstance(doc.get(key), bool):
            raise SchemaError(f"{key}: expected bool, got {doc.get(key)!r}")
    if doc.get("device") not in ("cpu", "cuda", None):
        raise SchemaError(f"device: {doc.get('device')!r}")

    rules = doc.get("rules")
    if not isinstance(rules, dict) or not rules:
        raise SchemaError("rules: expected non-empty object")
    for rid, meta in rules.items():
        if not RULE_ID.match(rid):
            raise SchemaError(f"rules: bad canonical id {rid!r}")
        _check_fields(meta, {"title": str}, f"rules.{rid}")
        gid = meta.get("graph_id")
        if gid is not None and not GRAPH_ID.match(gid):
            raise SchemaError(f"rules.{rid}.graph_id: bad mirror id {gid!r}")
    if not any(r.startswith("K") for r in rules):
        raise SchemaError("rules: no K-level rules — the kernel level is "
                          "missing from the catalog")

    for section, spec in (("entrypoints", ENTRYPOINT_KEYS),
                          ("kernels", KERNEL_KEYS)):
        items = doc.get(section)
        if not isinstance(items, list):
            raise SchemaError(f"{section}: expected list")
        for i, r in enumerate(items):
            _check_fields(r, spec, f"{section}[{i}]")
            if r["status"] not in ("ok", "error"):
                raise SchemaError(f"{section}[{i}].status: {r['status']!r} "
                                  "not in ('ok', 'error')")
            if r["status"] == "error" and not r["detail"]:
                raise SchemaError(f"{section}[{i}]: error with empty detail")

    findings = doc.get("findings")
    if not isinstance(findings, list):
        raise SchemaError("findings: expected list")
    n_suppressed = 0
    for i, f in enumerate(findings):
        _check_fields(f, FINDING_KEYS, f"findings[{i}]")
        if not RULE_ID.match(f["rule"]):
            raise SchemaError(f"findings[{i}].rule: non-canonical id "
                              f"{f['rule']!r} (W/K-form expected)")
        if f["level"] not in LEVELS:
            raise SchemaError(f"findings[{i}].level: {f['level']!r} not in "
                              f"{LEVELS}")
        if f["line"] < 0:
            raise SchemaError(f"findings[{i}].line: negative {f['line']!r}")
        if f["suppressed"]:
            n_suppressed += 1
            if not f["reason"].strip():
                raise SchemaError(f"findings[{i}]: suppressed without a "
                                  "reason — the suppression syntax makes "
                                  "the reason mandatory, so an empty one "
                                  "means the report lost it")

    counts = doc.get("counts")
    _check_fields(counts, COUNT_KEYS, "counts")
    if counts["total"] != len(findings):
        raise SchemaError(f"counts.total {counts['total']} != "
                          f"{len(findings)} findings")
    if counts["suppressed"] != n_suppressed:
        raise SchemaError(f"counts.suppressed {counts['suppressed']} != "
                          f"{n_suppressed} suppressed findings")
    if counts["active"] != counts["total"] - counts["suppressed"]:
        raise SchemaError("counts.active inconsistent with total/suppressed")

    errors = [r for r in doc["entrypoints"] + doc["kernels"]
              if r["status"] != "ok"]
    if doc["ok"] != (counts["active"] == 0 and not errors):
        raise SchemaError(f"ok={doc['ok']!r} inconsistent with "
                          f"{counts['active']} active findings and "
                          f"{len(errors)} errors")


def main(argv) -> int:
    path = argv[1] if len(argv) > 1 else "ANALYSIS_torch_report.json"
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"report: cannot load {path}: {e}", file=sys.stderr)
        return 2
    try:
        check(doc)
    except SchemaError as e:
        print(f"report: {path}: SCHEMA VIOLATION: {e}", file=sys.stderr)
        return 1
    c = doc["counts"]
    print(f"report: {path} ok — schema v{SCHEMA_VERSION}, "
          f"{len(doc['rules'])} rules, {len(doc['entrypoints'])} entry "
          f"points, {len(doc['kernels'])} kernels, {c['active']} active / "
          f"{c['suppressed']} suppressed findings")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
