"""The port's protocol analyzer (``repro_torch.analysis``) against its
known-bad corpus and against the JAX package's analyzer.

Every rule fires on its entry of ``tests/analysis_corpus_torch/`` and the
port's tree is silent (its suppressions carry reasons). Across packages:
the port's suppression parser reads comments as the reference's does, the
port's lint gives the reference's (rule, line) pairs on the reference's
corpus, the graph audit fires the rule the reference's jaxpr audit fires
on each twin of its corpus, and both trees suppress the same sites apart
from the listed exceptions.
"""
import ast
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from repro.analysis import jaxpr_audit as ja
from repro.analysis import lint as ref_lint
from repro.analysis import rules as ref_rules
from repro.core import wal as ref_wal
from repro_torch.analysis import graph_audit as ga
from repro_torch.analysis import kernel_audit as ka
from repro_torch.analysis import lint, report, rules
from repro_torch.analysis import __main__ as cli
from repro_torch.core import annotations as anno
from repro_torch.core import wal

TESTS = pathlib.Path(__file__).resolve().parent
CORPUS = TESTS / "analysis_corpus_torch"
REF_CORPUS = TESTS / "analysis_corpus"
ROOT = TESTS.parent


def _active(findings):
    return [f for f in findings if not f.suppressed]


def _fired(findings):
    return {f.rule for f in _active(findings)}


def _load(directory, name):
    spec = importlib.util.spec_from_file_location(
        f"corpus_{directory.name}_{name}", directory / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cas_args(with_stale=False):
    hdrs = torch.zeros((8, 2), dtype=torch.int32)
    slots = torch.arange(4, dtype=torch.int32)
    args = (hdrs, slots, torch.zeros((4, 2), dtype=torch.int32),
            torch.arange(4, dtype=torch.int32),
            torch.ones((4,), dtype=torch.bool))
    if with_stale:
        args += (torch.zeros((4,), dtype=torch.bool),)
    return args


def _ref_cas_args(with_stale=False):
    args = (jnp.zeros((8, 2), jnp.uint32), jnp.arange(4, dtype=jnp.int32),
            jnp.zeros((4, 2), jnp.uint32), jnp.arange(4, dtype=jnp.uint32),
            jnp.ones((4,), bool))
    return args + ((jnp.zeros((4,), bool),) if with_stale else ())


# ---------------------------------------------------------------- AST level

@pytest.mark.parametrize("name,rule", [
    ("w01_unpaired_lock", "W01"), ("w02_wrapping_order_key", "W02"),
    ("w03_sentinel_argmin", "W03"), ("w04_padded_append", "W04"),
    ("w05_raw_ring_window", "W05"), ("w06_clamped_scatter", "W06")])
def test_lint_fires_on_corpus(name, rule):
    assert rule in _fired(lint.lint_file(CORPUS / f"{name}.py"))


def test_w06_flags_both_spellings_and_not_the_fix():
    fs = [f for f in _active(lint.lint_file(CORPUS /
                                            "w06_clamped_scatter.py"))
          if f.rule == "W06"]
    text = (CORPUS / "w06_clamped_scatter.py").read_text().splitlines()
    lines = {text[f.line - 1].strip() for f in fs}
    assert lines == {"cur_hdr.index_put_((safe[rows],), new_hdr[rows])",
                     "cur_hdr[s, 0] = cur_hdr[s, 0] & ~1"}


def test_w06_corpus_writes_row_r_minus_1():
    """F1 itself: the clamped index writes slot R+5's header into row R-1;
    the fix drops it."""
    m = _load(CORPUS, "w06_clamped_scatter")
    R = 6
    slots = torch.tensor([1, R + 5], dtype=torch.int32)
    new = torch.tensor([[7, 7], [9, 9]], dtype=torch.int32)
    mask = torch.tensor([True, True])
    bad = m.bad_install(torch.zeros((R, 2), dtype=torch.int32), slots, new,
                        mask)
    good = m.good_install(torch.zeros((R, 2), dtype=torch.int32), slots,
                          new, mask)
    assert bad[R - 1].tolist() == [9, 9] and good[R - 1].tolist() == [0, 0]
    assert bad[1].tolist() == good[1].tolist() == [7, 7]


def test_lint_silent_on_tree():
    fs = lint.lint_paths([ROOT / p for p in lint.DEFAULT_SCOPE])
    assert _active(fs) == [], [f.render() for f in _active(fs)]
    assert any(f.suppressed for f in fs)
    assert all(f.reason for f in fs if f.suppressed)


def test_lint_default_scope_skips_the_corpus():
    scope = [ROOT / p for p in lint.DEFAULT_SCOPE]
    assert not any(CORPUS.is_relative_to(p) for p in scope)


def test_lint_torch_spellings():
    src = ("import torch\n"
           "from repro_torch._u32 import u64\n"
           "def f(ts_vec, ok, times, vec):\n"
           "    a = ts_vec.sum(dim=-1)\n"                       # 4: W02
           "    b = ts_vec.sum(dim=-1, dtype=torch.int64)\n"
           "    c = u64(ts_vec).sum(-1)\n"
           "    d = (u64(vec) & 0xFFFF).cumsum(0)\n"
           "    e = times.argmin()\n"                            # 8: W03
           "    g = torch.argmax(times)\n"                       # 9: W03
           "    h = (times < 0).to(torch.int8).argmax()\n"
           "    i = torch.where(ok, times, 0).argmax()\n"
           "    k = ok.to(torch.int8).argmax(dim=1)\n"           # 12: W03
           "    return a, b, c, d, e, g, h, i, k\n")
    got = {(f.rule, f.line) for f in lint.lint_source(src, "<t>")}
    assert got == {("W02", 4), ("W03", 8), ("W03", 9), ("W03", 12)}


def test_w06_follows_names_and_drops_reassigned_ones():
    src = ("from repro_torch._u32 import gidx, sidx\n"
           "def f(x, s, v, n):\n"
           "    a = gidx(s, n)\n"
           "    b = a.long()[s > 0]\n"
           "    x.index_add_(0, b, v)\n"                          # 5: W06
           "    x.scatter_reduce_(0, index=a, src=v, reduce='amax')\n"  # 6
           "    y = x[a]\n"
           "    a = sidx(s, n)\n"
           "    x[a] = v\n"
           "    x[s, gidx(s, n)] += 1\n"                          # 10: W06
           "    return y\n")
    got = {(f.rule, f.line) for f in lint.lint_source(src, "<t>")}
    assert got == {("W06", 5), ("W06", 6), ("W06", 10)}


def test_suppression_requires_reason(tmp_path):
    p = tmp_path / "no_reason.py"
    p.write_text("def f(times):\n"
                 "    return times.argmin()  # analysis: safe(W03)\n")
    assert "W03" in _fired(lint.lint_file(p))
    p.write_text("def f(times):\n"
                 "    # analysis: safe(A3): sentinel-free by construction\n"
                 "    return times.argmin()\n")
    fs = lint.lint_file(p)
    assert _active(fs) == [] and fs[0].reason == \
        "sentinel-free by construction"


def _py_sources(*dirs):
    for d in dirs:
        yield from sorted(d.rglob("*.py"))


def test_suppression_parser_equals_the_reference():
    extra = ["x = 1  # analysis: safe(W03): boolean operand",
             "# analysis: safe(w01, A3 ,K5): several, lower case",
             "# analysis: safe(W03):",
             "# analysis: safe(W03)  no colon",
             "#analysis:safe(K1):tight spacing",
             "# analysis: safe(A1): the A form"]
    texts = ["\n".join(extra)] + [p.read_text() for p in _py_sources(
        ROOT / "src" / "repro_torch", ROOT / "src" / "repro" / "core",
        ROOT / "src" / "repro" / "kernels")]
    n = 0
    for text in texts:
        got = rules.scan_suppressions(text)
        assert got == ref_rules.scan_suppressions(text)
        n += len(got)
    assert n >= 15
    for rid in ("A1", "A2", "A3", "A4", "w05", "K3"):
        assert rules.canonical(rid) == ref_rules.canonical(rid)


@pytest.mark.parametrize("name", [
    "w01_unpaired_lock", "w02_wrapping_order_key", "w03_sentinel_argmin",
    "w04_padded_append", "w05_raw_ring_window"])
def test_port_lint_reads_the_reference_corpus_as_the_reference(name):
    path = REF_CORPUS / f"{name}.py"
    pairs = lambda fs: sorted((f.rule, f.line) for f in _active(fs))  # noqa
    assert pairs(lint.lint_file(path)) == pairs(ref_lint.lint_file(path))
    assert pairs(lint.lint_file(path))


def _enclosing(path, line):
    tree = ast.parse(pathlib.Path(path).read_text())
    best = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.lineno <= line <= node.end_lineno:
            if best is None or node.lineno > best.lineno:
                best = node
    return best.name if best else "<module>"


# sites the two trees do not share: the Pallas kernel bodies (CUDA C++ in
# the port), the jaxpr audit's replay fixture (the graph audit's is
# `_replay`: it runs, it does not trace), and the port's Gumbel-max draw
# (the reference calls jax.random.categorical)
REF_ONLY = {("W03", "_resolve_versions"), ("W04", "_trace_replay")}
PORT_ONLY = {("W04", "_replay"), ("W03", "_categorical")}


def test_suppressed_sites_correspond_across_packages():
    def sites(fs):
        return {(f.rule, _enclosing(f.file, f.line)) for f in fs
                if f.suppressed}
    port = sites(lint.lint_paths([ROOT / p for p in lint.DEFAULT_SCOPE]))
    ref = sites(ref_lint.lint_paths([ROOT / p
                                     for p in ref_lint.DEFAULT_SCOPE]))
    assert ref - REF_ONLY == port - PORT_ONLY, (ref, port)
    assert REF_ONLY <= ref and PORT_ONLY <= port


# -------------------------------------------------------------- graph level

def _graph(fn, *args, **kw):
    return ga.audit_callable(fn, *args, **kw)[0]


def test_graph_silent_on_tree_and_pairs_locks():
    findings, reports = ga.audit_tree("cpu")
    assert {r.name for r in reports} == set(ga.ENTRYPOINTS)
    assert all(r.status == "ok" and r.n_ops > 0 for r in reports), reports
    assert _active(findings) == [], [f.render() for f in _active(findings)]
    for r in reports:
        if ga.ENTRYPOINTS[r.name][1]:
            assert anno.LOCK_GRANTED in r.tags[anno.LOCK_RELEASED]["from"]
            assert anno.LOCK_GRANTED in r.tags[anno.COMMIT_COMMITTED]["from"]


def test_graph_twins_fire_the_reference_rule():
    rm, tm = (_load(REF_CORPUS, "w01_unpaired_lock"),
              _load(CORPUS, "w01_unpaired_lock"))
    cases = [
        (ja.audit_callable(rm.bad_round_no_release, *_ref_cas_args(),
                           expects_locks=True),
         _graph(tm.bad_round_no_release, *_cas_args(), expects_locks=True)),
        (ja.audit_callable(rm.bad_round_foreign_release,
                           *_ref_cas_args(True), expects_locks=True),
         _graph(tm.bad_round_foreign_release, *_cas_args(True),
                expects_locks=True)),
    ]
    rm, tm = (_load(REF_CORPUS, "w02_wrapping_order_key"),
              _load(CORPUS, "w02_wrapping_order_key"))
    ts = torch.zeros((3, 4, 5), dtype=torch.int32)
    cases.append((ja.audit_callable(rm.bad_order_key,
                                    jnp.zeros((3, 4, 5), jnp.uint32)),
                  _graph(tm.bad_order_key, ts, sources=(ts,))))
    rm, tm = (_load(REF_CORPUS, "w03_sentinel_argmin"),
              _load(CORPUS, "w03_sentinel_argmin"))
    cases.append((
        ja.audit_callable(rm.bad_take_snapshot, jnp.full((8,), -1, jnp.int32),
                          jnp.zeros((8, 6), jnp.uint32), jnp.int32(7),
                          jnp.zeros((6,), jnp.uint32)),
        _graph(tm.bad_take_snapshot, torch.full((8,), -1, dtype=torch.int32),
               torch.zeros((8, 6), dtype=torch.int32), 7,
               torch.zeros((6,), dtype=torch.int32))))
    rm, tm = (_load(REF_CORPUS, "w04_padded_append"),
              _load(CORPUS, "w04_padded_append"))
    rj = ref_wal.init_journal(4, 4, n_slots=6, ws=2, width=4)
    tj = wal.init_journal(4, 4, n_slots=6, ws=2, width=4, device="cpu")
    i32 = dict(dtype=torch.int32)
    cases.append((
        ja.audit_callable(rm.bad_append, rj, jnp.arange(4, dtype=jnp.int32),
                          jnp.zeros((8,), jnp.uint32),
                          jnp.zeros((4, 2), jnp.int32),
                          jnp.zeros((4, 2, 2), jnp.uint32),
                          jnp.zeros((4, 2, 4), jnp.int32),
                          jnp.ones((4, 2), bool)),
        _graph(tm.bad_append, tj, torch.arange(4, **i32),
               torch.zeros((8,), **i32), torch.zeros((4, 2), **i32),
               torch.zeros((4, 2, 2), **i32), torch.zeros((4, 2, 4), **i32),
               torch.ones((4, 2), dtype=torch.bool))))
    for want, (ref, port) in zip(["W01", "W01", "W02", "W03", "W04"], cases):
        assert want in _fired(ref), [f.render() for f in ref]
        assert _fired(port) == {want}, [f.render() for f in port]


def test_graph_silent_on_the_digit_split_and_the_fixed_selection():
    j = wal.init_journal(2, 4, n_slots=5, ws=2, width=4, device="cpu")
    j.ts_vec.fill_(-2)        # words past 2^31
    assert not _graph(lambda: wal._order_keys(j, 0), sources=(j.ts_vec,))
    times = torch.tensor([3, -1, 5], dtype=torch.int32)
    unused = times < 0
    assert not _graph(lambda: torch.where(
        unused.any(), unused.to(torch.int8).argmax(),
        torch.where(unused, 0, times).argmin()))


def test_graph_maps_findings_to_lines_and_honors_suppressions():
    m = _load(CORPUS, "w03_sentinel_argmin")
    (f,) = _graph(m.bad_take_snapshot, torch.zeros(4, dtype=torch.int32),
                  torch.zeros((4, 2), dtype=torch.int32), 1,
                  torch.zeros(2, dtype=torch.int32))
    text = (CORPUS / "w03_sentinel_argmin.py").read_text().splitlines()
    assert f.file.endswith("w03_sentinel_argmin.py")
    assert text[f.line - 1].strip() == "pos = times.argmin()"
    ga_fs, _ = ga.audit_tree("cpu")
    sup = [f for f in ga_fs if f.suppressed]
    assert sup and all(f.file.endswith("core/gc.py") for f in sup)


def test_tags_change_nothing():
    x = torch.ones(3, dtype=torch.bool)
    assert anno.tag(x, anno.LOCK_GRANTED) is x
    seen = []
    ga.audit_callable(lambda: seen.append(anno.tag(x, anno.LOCK_GRANTED)))
    assert seen[0] is x and anno._hook is None


def test_removing_a_tag_fires_w01(tmp_path):
    """On a copy of the port whose commit_write_sets has lost its release
    tag, the graph audit of si.run_round reports W01."""
    src = tmp_path / "src"
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    si_py = src / "repro_torch" / "core" / "si.py"
    text = si_py.read_text()
    tagged = "release_mask = anno.tag(granted & ~txn_c, anno.LOCK_RELEASED)"
    assert text.count(tagged) == 1
    si_py.write_text(text.replace(tagged, "release_mask = granted & ~txn_c"))
    code = ("import json; from repro_torch.analysis import graph_audit as g;"
            "fs, _ = g.audit_tree('cpu');"
            "print(json.dumps([(f.rule, f.msg) for f in fs "
            "if not f.suppressed]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(src)})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got and {r for r, _ in got} == {"W01"}
    assert all("[si.run_round]" in m for _, m in got)


# ------------------------------------------------------------- kernel level

def test_k5_parity_drifts():
    m = _load(CORPUS, "k05_missing_ref")
    for ops, ref, names in [
            (m.OPS_NO_ENTRY, m.REF_NO_ENTRY, ["lookup"]),
            (m.OPS_MISSING_REF, m.REF_MISSING_REF, ["lookup"]),
            (m.OPS_SIG_DRIFT, m.REF_SIG_DRIFT, ["commit"]),
            (m.OPS_KW_DRIFT, m.REF_KW_DRIFT, ["scan"])]:
        fs = ka.check_ref_parity_sources(ops, "<ops>", ref, names,
                                         m.CROSS_TESTS, m.CROSS_TESTS)
        assert _fired(fs) == {"K5"}, (names, [f.render() for f in fs])
    assert not ka.check_ref_parity_sources(
        m.OPS_GOOD, "<ops>", m.REF_GOOD, ["probe"], m.CROSS_TESTS,
        m.GPU_TESTS)
    fs = ka.check_ref_parity_sources(m.OPS_SIG_DRIFT.replace(
        "requests", "slots"), "<ops>", m.REF_SIG_DRIFT.replace(
        "requests", "slots"), ["commit"], m.CROSS_TESTS, m.GPU_TESTS)
    assert len(fs) == 1 and "test_torch_gpu" in fs[0].msg


def test_k5_on_the_tree_takes_the_build_list():
    fs = ka.check_ref_parity()
    assert _active(fs) == [], [f.render() for f in _active(fs)]
    (sup,) = [f for f in fs if f.suppressed]
    assert sup.file.endswith("mamba_scan/ops.py") and "h0" in sup.msg


def test_k3_corpus_and_design_points():
    m = _load(CORPUS, "k03_smem_hog")
    assert _fired(ka.check_smem([m.BAD])) == {"K3"}
    assert not ka.check_smem([m.GOOD])
    points = ka.design_points()
    assert {p.library for p in points} == set(ka._build.KERNELS)
    assert not ka.check_smem(points)
    findings, reports = ka.audit_kernels(points + [m.BAD])
    assert _fired(findings) == {"K3"}
    assert next(r for r in reports if r.name == "flash_attention") \
        .smem_bytes == m.BAD.smem


def test_design_points_are_the_wrappers_own_at_each_architecture():
    """An architecture's points are its kernels' ``launch_points`` at its
    own widths: a head dim the kernels do not take (h2o-danube's 120) and
    a model without attention (xlstm) give none."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_gmm import ops as mg
    from repro_torch.kernels.paged_attention import ops as pa
    by_arch = {}
    for p in ka.design_points():
        by_arch.setdefault(p.label.split(":")[0], []).append(
            (p.library, p.function, p.threads, p.smem))
    for arch, D, g in (("gemma2-27b", 128, 2), ("paligemma-3b", 256, 8),
                       ("mixtral-8x22b", 128, 6)):
        assert ("flash_attention", *fa.tc_points(D)[0]) in by_arch[arch]
        part = pa.launch_points(D, g, 2, 32768 // 16, 16)
        assert len(part) == 2 and all(
            ("paged_attention", *q) in by_arch[arch] for q in part)
    cfg = get_arch("mixtral-8x22b")
    assert all(("moe_gmm", *q) in by_arch["mixtral-8x22b"]
               for q in mg.launch_points(cfg.activation, True))
    assert {q[0] for q in by_arch["jamba-v0.1-52b"]} == {
        "flash_attention", "paged_attention", "moe_gmm", "mamba_scan"}
    assert "h2o-danube-3-4b" not in by_arch and "xlstm-350m" not in by_arch


def test_launched_lists_what_the_wrappers_recorded():
    import collections
    import importlib
    import types
    w = types.SimpleNamespace(launched=collections.Counter(
        {("flash_tc_kernel<64>", 288, 66_640): 3,
         ("flash_kernel<64>", 512, 1_000): 1}))
    assert ka.launched({"flash_attention": w}) == [
        ka.KernelSpec("launched 1 times", "flash_attention",
                      "flash_kernel<64>", 512, 1_000),
        ka.KernelSpec("launched 3 times", "flash_attention",
                      "flash_tc_kernel<64>", 288, 66_640)]
    for name in ka._build.KERNELS:
        ops = importlib.import_module(
            f"repro_torch.kernels.{ka.PACKAGE_OF.get(name, name)}.ops")
        assert isinstance(getattr(ops, name).launched, collections.Counter)


def test_card_k3_logic_on_given_resources():
    p = ka.KernelSpec("x", "moe_gmm", "gmm_tc_kernel<0>", 288, 197_696)
    ok = {"moe_gmm": {"gmm_tc_kernel<0>": (154, 1024)}}
    fs, rows = ka.card_k3(ka._cuda.MAX_SMEM, [p], ok)
    assert not fs and rows[0].smem == 198_720 \
        and rows[0].registers_a_block == 160 * 288
    for usage, optin, what in (
            ({"moe_gmm": {"gmm_tc_kernel<1>": (154, 1024)}}, None, "no built"),
            ({"moe_gmm": {"gmm_tc_kernel<0>": (229, 1024)}}, None,
             "registers"),
            ({"moe_gmm": {"gmm_tc_kernel<0>": (154, 40_000)}}, None,
             "static"),
            (ok, 200_000, "optin")):
        fs, _ = ka.card_k3(optin or ka._cuda.MAX_SMEM, [p], usage)
        assert _fired(fs) == {"K3"} and any(what in f.msg for f in fs), what


def test_demangled_names_lose_namespace_casts_and_parameters():
    assert ka._short("void (anonymous namespace)::scan_kernel<float, (int)16>"
                     "(float const*, int)") == "scan_kernel<float, 16>"
    assert ka._short("(anonymous namespace)::fused_commit_kernel("
                     "(anonymous namespace)::Args)") == "fused_commit_kernel"


# ------------------------------------------------------- the report, the CLI

def test_cli_report_passes_its_schema_check(tmp_path, capsys):
    out, sarif = tmp_path / "r.json", tmp_path / "r.sarif"
    assert cli.main(["--strict", "--device", "cpu", "--out", str(out),
                     "--sarif", str(sarif)]) == 0
    doc = json.loads(out.read_text())
    report.check(doc)
    assert doc["ok"] and doc["device"] == "cpu"
    assert {e["name"] for e in doc["entrypoints"]} == set(ga.ENTRYPOINTS)
    assert {k["name"] for k in doc["kernels"]} == set(ka._build.KERNELS)
    assert report.main(["report", str(out)]) == 0
    s = json.loads(sarif.read_text())
    assert s["version"] == "2.1.0"
    assert all(r["level"] == "note" and r["suppressions"]
               for r in s["runs"][0]["results"])
    bad = dict(doc, findings=[dict(doc["findings"][0], reason=" ")])
    bad["counts"] = dict(doc["counts"], total=1, suppressed=1, active=0)
    with pytest.raises(report.SchemaError, match="reason"):
        report.check(bad)


def test_cli_strict_fails_on_an_active_finding(tmp_path):
    out = tmp_path / "r.json"
    assert cli.main(["--strict", "--device", "cpu", "--no-graph",
                     "--no-kernel", "--out", str(out),
                     str(CORPUS / "w06_clamped_scatter.py")]) == 1
    doc = json.loads(out.read_text())
    report.check(doc)
    assert not doc["ok"] and doc["counts"]["active"] == 2


def test_graph_audit_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ga.audit_tree()


def test_an_audited_round_equals_the_round():
    """The audit observes and changes nothing: the protocol state after an
    audited round equals the state after the same round run plainly."""
    plain, plain_state = ga._run_round("cpu")
    audited, audited_state = ga._run_round("cpu")
    plain()
    ga.audit_callable(audited)
    for a, b in zip(plain_state, audited_state):
        assert torch.equal(a, b)
