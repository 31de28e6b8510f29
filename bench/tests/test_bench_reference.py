"""The reference against the port at a tiny size on the CPU (every cell's
driver, trace and no trace), the control that must come out not correct,
and the faults the comparison must catch."""
import json

import pytest
import torch

from bench import cell, control, run
from bench.tests import tiny
from repro_torch.db import tpcc, workload
from repro_torch.kernels.commit import ops as commit_ops


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _run(root, name, seed=2**31 + 7, seconds=1.0, trace=0,
         device="cpu"):
    spec = cell.load(root, name)
    return run.run_cell(spec, seed, seconds, bool(trace), device,
                        log=lambda m: None)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", list(tiny.CELLS))
def test_reference_equals_the_port(root, name, trace):
    res = _run(root, name, trace=trace)
    assert res["correct"], res["numbers"]
    assert res["attempted"] > 0 and res["failed"] == 0
    stats = res["window"]["stats"]
    assert sum(v for k, v in stats.items() if k.startswith("commits")) > 0


@pytest.mark.parametrize("name", ["t1.mix", "t1.neworder", "t4.mix"])
def test_reference_equals_the_port_with_gc(tmp_path, name):
    """The 5.3 GC thread on (a sweep every 2 rounds), as a later cell may
    run it."""
    root = tiny.make_root(tmp_path, {name: tiny.CELLS[name]}, gc_interval=2,
                          max_txn_time=1)
    res = _run(root, name, seconds=2.0)
    assert res["correct"], res["numbers"]
    assert res["window"]["stats"]["gc_sweeps"] > 0


def test_the_result_line(root, capsys):
    rc = run.main(["--workload", "t1.mix", "--seed", "9", "--seconds",
                   "0.5", "--trace", "0"], root=root, device="cpu")
    out, err = capsys.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"]
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("failed 0 limit 0")


@pytest.mark.parametrize("name", list(tiny.CELLS))
def test_control_is_not_correct(root, name):
    spec = cell.load(root, name)
    nums = control.run(spec, 11, 12, "cpu", workload)
    assert nums["decisions"] > 0 and nums["rows"] > 0


def _unchanged_state(monkeypatch):
    """Every write sub-round returns its outcome but leaves the state as it
    found it."""
    for name in ("neworder_round", "payment_round", "delivery_round",
                 "neworder_round_distributed", "payment_round_distributed",
                 "delivery_round_distributed"):
        fn = getattr(tpcc, name)

        def wrapped(cfg, lay, st, *a, _fn=fn, **k):
            before = cell.clone_tree(st)
            out = _fn(cfg, lay, st, *a, **k)
            _copy_into(out.state, before)
            return out._replace(state=before)
        monkeypatch.setattr(tpcc, name, wrapped)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        if dst.shape == src.shape:
            dst.copy_(src)
        return
    if isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _copy_into(a, b)


def _half_batch(monkeypatch):
    """Every sub-round runs the lower half of its threads only."""
    for name in ("neworder_round", "payment_round", "delivery_round",
                 "orderstatus_round", "stocklevel_round",
                 "neworder_round_distributed", "payment_round_distributed",
                 "delivery_round_distributed"):
        fn = getattr(tpcc, name)

        def wrapped(cfg, lay, st, oracle, *a, _fn=fn, **k):
            T = cfg.n_threads
            half = torch.arange(T, device=st.nam.table.cur_hdr.device) < T // 2
            act = k.get("active")
            k["active"] = half if act is None else act & half
            return _fn(cfg, lay, st, oracle, *a, **k)
        monkeypatch.setattr(tpcc, name, wrapped)


def _no_exchange(monkeypatch):
    """Each memory server decides alone: the decide-only launches report
    no failure, so no server hears of another's."""
    fn = commit_ops.fused_commit

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if k.get("decide_only"):
            out = out._replace(fails=torch.zeros_like(out.fails))
        return out
    monkeypatch.setattr(commit_ops, "fused_commit", wrapped)


def _altered_answer(monkeypatch):
    """Payment reports thread 0's outcome flipped where it is produced."""
    for name in ("payment_round", "payment_round_distributed"):
        fn = getattr(tpcc, name)

        def wrapped(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            c = out.committed.clone()
            c[0] = ~c[0] & k["active"][0]
            return out._replace(committed=c)
        monkeypatch.setattr(tpcc, name, wrapped)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer, "no_exchange": _no_exchange}


@pytest.mark.parametrize("name", list(tiny.CELLS))
@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_are_not_correct(root, name, fault, monkeypatch):
    if fault == "no_exchange" and name != "t4.mix":
        pytest.skip("one memory server exchanges nothing")
    if fault == "altered_answer" and "mix" not in name:
        pytest.skip("new-order alone runs no payment")
    FAULTS[fault](monkeypatch)
    res = _run(root, name, seconds=0.5)
    assert not res["correct"], res["numbers"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tiny.CELLS))
def test_tiny_cells_on_the_card(root, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(root, name, device="cuda")
    assert res["correct"], res["numbers"]
