"""The example scripts (``examples/<name>.py``) for the tests: the
port's loaded as modules or run as programs, the reference's run in this
process. Imports no JAX, so the card's tests use it too."""
import contextlib
import importlib.util
import io
import runpy
import subprocess
import sys
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_program(script, argv, last):
    """``script`` run as a program on the CPU: exit 0, ``last`` last."""
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / script), "--device", "cpu"] + argv,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1] == last


def _reference_output(name, argv, monkeypatch):
    """The lines a reference example prints, run in this process."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    return out.getvalue().splitlines()
