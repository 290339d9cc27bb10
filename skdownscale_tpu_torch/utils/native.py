"""ctypes binding to the repository's native grid-pack library
(``native/gridpack.cpp``), the same ``libgridpack.so`` that
``skdownscale_tpu/utils/native.py`` binds.

The native path fuses the (time, feature, cell) -> (valid_cell, time,
feature) gather+transpose in one multithreaded host pass.  The library is
built with ``make -C native`` at first use when a compiler is available;
every entry point keeps its numpy fallback (host packing, not device code).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["pack_compact", "unpack_scatter", "valid_mask"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgridpack.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _ensure_built() -> bool:
    """Build ``libgridpack.so`` if it is missing or older than its source (a
    stale binary, possibly compiled with ``-march=native`` elsewhere, is never
    loaded)."""
    src = os.path.join(_NATIVE_DIR, "gridpack.cpp")
    if not os.path.exists(src):
        return os.path.exists(_LIB_PATH)
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(src):
        return True
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "libgridpack.so"],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return os.path.exists(_LIB_PATH)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _ensure_built():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.gridpack_pack_f32.argtypes = [f32p, f32p, i32p, i64, i64, i64, i64]
        lib.gridpack_pack_f64.argtypes = [f64p, f64p, i32p, i64, i64, i64, i64]
        lib.gridpack_unpack_f32.argtypes = [f32p, f32p, i32p, i64, i64, i64, i64, ctypes.c_float]
        lib.gridpack_unpack_f64.argtypes = [f64p, f64p, i32p, i64, i64, i64, i64, ctypes.c_double]
        lib.gridpack_valid_mask_f32.argtypes = [f32p, u8p, i64]
        lib.gridpack_valid_mask_f32.restype = i64
        lib.gridpack_valid_mask_f64.argtypes = [f64p, u8p, i64]
        lib.gridpack_valid_mask_f64.restype = i64
        _lib = lib
        return _lib


def pack_compact(src: np.ndarray, cell_ids: np.ndarray) -> np.ndarray:
    """(T, F, C) -> (n_valid, T, F) gathering the cells in ``cell_ids``."""
    lib = _load()
    T, F, C = src.shape
    cell_ids = np.ascontiguousarray(cell_ids, dtype=np.int32)
    nv = len(cell_ids)
    if lib is not None and src.dtype in (np.float32, np.float64):
        src = np.ascontiguousarray(src)
        dst = np.empty((nv, T, F), dtype=src.dtype)
        fn = lib.gridpack_pack_f32 if src.dtype == np.float32 else lib.gridpack_pack_f64
        fn(src, dst, cell_ids, T, F, C, nv)
        return dst
    return np.moveaxis(src, 2, 0)[cell_ids]


def unpack_scatter(src: np.ndarray, cell_ids: np.ndarray, n_cells: int, fill=np.nan) -> np.ndarray:
    """(n_valid, T, O) -> (T, O, C) scattering rows to ``cell_ids``."""
    lib = _load()
    nv, T, O = src.shape
    cell_ids = np.ascontiguousarray(cell_ids, dtype=np.int32)
    if lib is not None and src.dtype in (np.float32, np.float64):
        src = np.ascontiguousarray(src)
        dst = np.empty((T, O, n_cells), dtype=src.dtype)
        fn = lib.gridpack_unpack_f32 if src.dtype == np.float32 else lib.gridpack_unpack_f64
        fn(src, dst, cell_ids, T, O, n_cells, nv, fill)
        return dst
    out = np.full((T, O, n_cells), fill, dtype=src.dtype)
    out[:, :, cell_ids] = np.moveaxis(src, 0, 2)
    return out


def valid_mask(first_slice: np.ndarray) -> np.ndarray:
    """NaN-cell mask from a (C,) slice (reference ``_make_mask``, core.py:35)."""
    lib = _load()
    first_slice = np.ascontiguousarray(first_slice)
    C = first_slice.shape[0]
    if lib is not None and first_slice.dtype in (np.float32, np.float64):
        mask = np.empty(C, dtype=np.uint8)
        fn = (
            lib.gridpack_valid_mask_f32
            if first_slice.dtype == np.float32
            else lib.gridpack_valid_mask_f64
        )
        fn(first_slice, mask, C)
        return mask.astype(bool)
    return np.isfinite(first_slice)
