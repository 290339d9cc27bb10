"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, sizes and the
stream as ``void*``), so it compiles in seconds without PyTorch's headers.
The library goes to ``skdownscale_tpu_torch/_build/`` (ignored by git) under
a name that carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is never served a stale
binary.  Nothing is built at import time: the first
wrapper call on a CUDA tensor builds, later calls reuse the loaded library.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

__all__ = ["NVCC_FLAGS", "SOURCES", "BuildResult", "build", "build_all", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# every CUDA source of the package, by name (csrc/<name>.cu)
SOURCES = ("rank_map", "slide_sort", "interp", "knn", "sort_rows")

# one lock per library: two threads never build the same library at once,
# while different sources (or builds of one source with other switches)
# build side by side
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock(lib: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(lib, threading.Lock())


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


def _headers() -> list[str]:
    """The shared headers (``csrc/*.cuh``): a source that includes one is
    rebuilt when it changes."""
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))


def build(name: str, defines: tuple[str, ...] = ()) -> BuildResult:
    """Compile ``csrc/<name>.cu`` for sm_90a into the build directory;
    ``defines`` (``"NAME=value"``) set a source's trial switches."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    h = hashlib.sha256(" ".join(flags).encode())
    for path in (src, *_headers()):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    with _lock(lib):
        if os.path.exists(lib):
            try:  # the build's own log, kept beside the library
                with open(f"{lib}.log") as f:
                    return BuildResult(lib, 0.0, f.read())
            except OSError:
                return BuildResult(lib, 0.0, "up to date")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, src],
            capture_output=True,
            text=True,
            timeout=600,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        with open(f"{lib}.log", "w") as f:
            f.write(log)
        os.replace(tmp, lib)
        return BuildResult(lib, seconds, log)


def build_all() -> dict[str, BuildResult]:
    """Build every source in :data:`SOURCES`, one ``nvcc`` each, all
    started together."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(build(name).path)
