"""Build and load the port's CUDA kernels.

Each kernel is one source under ``src/repro_torch/csrc/`` with a plain C
interface; device code shared between sources lives in headers there
(``*.cuh``). A kernel is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

into the repository's ``build/`` directory and loaded with ``ctypes``.
The file name carries a hash of the source, the shared headers and the
flags, so an edited source or header builds anew. A missing ``nvcc`` or a failed build raises; nothing
falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
KERNELS = ("batched_probe", "fused_commit", "hash_probe", "flash_attention",
           "paged_attention", "moe_gmm", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD = Path(__file__).resolve().parents[3] / "build"

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.pathsep.join(p for p in (os.environ.get("PATH", ""),
                                       os.path.join(cuda_home, "bin")) if p)
    nvcc = shutil.which("nvcc", path=path)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "toolkit is needed to build the port's kernels (set CUDA_HOME "
            "to point at it)")
    return nvcc


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return src, BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def library(name: str) -> Path:
    """The path of kernel ``name``'s shared library for the sources and
    flags as they stand (built or not)."""
    return _target(name)[1]


def _start(name: str, nvcc: str):
    """Start compiling ``name`` unless its library exists; returns the
    running process (or None) and the library path."""
    src, lib = _target(name)
    if lib.exists():
        return None, lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.lib, proc.tmp, proc.name = lib, tmp, name
    return proc, lib


def _finish(proc) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {proc.name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(proc.tmp, proc.lib)
    return out


def build_all(names=KERNELS) -> dict:
    """Compile every named kernel at once, one ``nvcc`` each, all started
    together. Returns ``{name: compiler output}`` (empty when cached)."""
    nvcc = find_nvcc()
    started = [(n, *_start(n, nvcc)) for n in names]
    return {n: _finish(p) if p is not None else "" for n, p, _ in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        if name not in _loaded:
            build_all((name,))
            _loaded[name] = ctypes.CDLL(str(_target(name)[1]))
        return _loaded[name]
