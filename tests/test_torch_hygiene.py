"""Rules the PyTorch port keeps: no JAX and nothing of the reference
package in its code, no silent run on the CPU, no kernel build without the
CUDA toolkit."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import gc
from repro_torch.core.tsoracle import VectorOracle
from repro_torch.db import tpcc
from repro_torch.kernels import _build
from repro_torch.models import api, recurrent
from repro_torch.serve import engine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "examples").glob("*_torch.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_refuse_to_run_on_the_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tpcc.TPCCConfig(n_warehouses=1, customers_per_district=4,
                          n_items=16, n_threads=2, orders_per_thread=4)
    oracle = VectorOracle(cfg.n_threads)
    with pytest.raises(RuntimeError, match="CUDA"):
        oracle.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpcc.init_tpcc(cfg, oracle)
    lay, st = tpcc.init_tpcc(cfg, oracle, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpcc.run_neworder_rounds(cfg, lay, st, oracle, lambda r: None, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpcc.run_mixed_rounds(cfg, lay, st, oracle, lambda r: None, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpcc.make_journal(cfg, oracle, capacity_rounds=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        gc.init_log(2, oracle.n_slots)


def test_serve_entry_points_refuse_the_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_arch("granite-3-8b"))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.build(cfg).init(gen)
    model = api.build(cfg).init(gen, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.Engine(cfg, model, engine.EngineConfig())
    eng = engine.Engine(cfg, model, engine.EngineConfig(), device="cpu")
    assert eng.init_state().tokens.device.type == "cpu"


def test_recurrent_entry_points_refuse_the_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for aid in ("jamba-v0.1-52b", "xlstm-350m"):
        with pytest.raises(RuntimeError, match="CUDA"):
            api.build(reduced(get_arch(aid))).init(gen)
    for make in (lambda **kw: recurrent.init_mamba(16, **kw),
                 lambda **kw: recurrent.init_mlstm(16, 2, **kw),
                 lambda **kw: recurrent.init_slstm(16, 2, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(generator=gen)
        assert next(make(generator=gen, device="cpu").parameters()) \
            .device.type == "cpu"
    for init in (lambda **kw: recurrent.mlstm_init_cache(1, 2, 8, **kw),
                 lambda **kw: recurrent.slstm_init_cache(1, 16, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            init()
        assert init(device="cpu").m.device.type == "cpu"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_loaded", {})
    for name in _build.KERNELS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_train_entry_points_refuse_the_cpu_silently(monkeypatch):
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainstep import make_train_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_arch("granite-3-8b"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(dcfg, 0)
    batch = make_batch(dcfg, 0, device="cpu")
    assert batch["tokens"].device.type == "cpu"
    model = api.build(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
    step = make_train_step(api.build(cfg), opt.AdamWConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        step(model, opt.init(model), batch)
    step = make_train_step(api.build(cfg), opt.AdamWConfig(), device="cpu")
    _, st, metrics = step(model, opt.init(model), batch)
    assert int(st.step) == 1 and torch.isfinite(metrics["loss"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--reduced", "--steps", "1"])
