"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, sizes and the
stream as ``void*``), so it compiles in seconds without PyTorch's headers.
The library goes to ``skdownscale_tpu_torch/_build/`` (ignored by git) under
a name that carries a hash of the source and the flags, so an edited source
is never served a stale binary.  Nothing is built at import time: the first
wrapper call on a CUDA tensor builds, later calls reuse the loaded library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

__all__ = ["NVCC_FLAGS", "BuildResult", "build", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()


class BuildResult(NamedTuple):
    path: str
    seconds: float  # 0.0 when an up-to-date library was already on disk
    log: str  # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` for sm_90a into the build directory."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    with _lock:
        if os.path.exists(lib):
            return BuildResult(lib, 0.0, "up to date")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True,
            text=True,
            timeout=600,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        return BuildResult(lib, seconds, log)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(build(name).path)
