"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library, ``ctypes``.

Each kernel source ``csrc/<name>.cu`` exports plain C functions.  At first use
it is compiled for Hopper (``sm_90a``) into ``build/repro_torch_kernels/`` at
the root of the source tree, under a file name that carries the hash of the
source and the flags, so a changed source is rebuilt and an unchanged one is
loaded as it is.  Nothing is compiled or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library", "load_library", "nvcc_path"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# <root>/src/repro_torch/kernels/build.py -> <root>/build/repro_torch_kernels
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libraries: dict[str, ctypes.CDLL] = {}
#: what ``nvcc`` printed for each library built in this process (ptxas
#: register and shared-memory report); empty for a library loaded as built
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    out = _library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_logs[name] = proc.stdout + proc.stderr
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    lib = _libraries.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name)))
        _libraries[name] = lib
    return lib
