"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `fastlivo_tpu_torch/csrc/` is compiled at first use into
`fastlivo_tpu_torch/_build/` (listed in .gitignore) as a shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The library's file name carries a hash of its source, so an edited source
is rebuilt. A failed build raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel library name -> source file under csrc/
SOURCES = {"extract_windows": "extract_windows.cu", "patch_sample": "patch_sample.cu"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str):
    """Start nvcc for `name` unless its library is current; returns the
    running process (or None) and the library path."""
    lib = library_path(name)
    if lib.exists():
        return None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return (proc, tmp), lib


def _finish_build(name: str, job, lib: Path) -> None:
    if job is None:
        return
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)


def build_all() -> Dict[str, Path]:
    """Compile every kernel source at once (one nvcc per source, all
    started together) and return the library paths."""
    jobs = {name: _start_build(name) for name in SOURCES}
    for name, (job, lib) in jobs.items():
        _finish_build(name, job, lib)
    return {name: lib for name, (_, lib) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        job, path = _start_build(name)
        _finish_build(name, job, path)
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
