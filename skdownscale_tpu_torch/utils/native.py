"""ctypes bindings to the repository's native host libraries, the same
``.so`` files that ``skdownscale_tpu/utils/native.py`` binds.

``libgridpack.so`` (``native/gridpack.cpp``) fuses the (time, feature, cell)
-> (valid_cell, time, feature) gather+transpose in one multithreaded host
pass; its entry points keep their numpy fallback (host packing, not device
code).  ``libblosclite.so`` (``native/blosclite.cpp``, ``zstdlite.cpp``) is
the c-blosc1-compatible LZ4 frame codec, the zstd decoder and the CRC-32C
that :mod:`.zarrlite` reads and writes zarr chunks with.  Each library is
built with ``make -C native`` at first use when a compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "available",
    "pack_compact",
    "unpack_scatter",
    "valid_mask",
    "blosc_available",
    "blosc_compress",
    "blosc_decompress",
    "zstd_decompress",
    "crc32c",
]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgridpack.so")
_BLOSC_LIB_PATH = os.path.join(_NATIVE_DIR, "libblosclite.so")

_lock = threading.Lock()
_lib = None
_tried = False
_blosc_lib = None
_blosc_tried = False


def _ensure_built(lib_path: str, sources: tuple[str, ...]) -> bool:
    """Build ``lib_path`` (a target of ``native/Makefile``) if it is missing
    or older than any of its ``sources`` (a stale binary, possibly compiled
    with ``-march=native`` elsewhere, is never loaded)."""
    srcs = [os.path.join(_NATIVE_DIR, s) for s in sources]
    if not all(os.path.exists(s) for s in srcs):
        return os.path.exists(lib_path)
    if os.path.exists(lib_path) and all(
        os.path.getmtime(lib_path) >= os.path.getmtime(s) for s in srcs
    ):
        return True
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, os.path.basename(lib_path)],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return os.path.exists(lib_path)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _ensure_built(_LIB_PATH, ("gridpack.cpp",)):
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


def available() -> bool:
    """Whether ``native/libgridpack.so`` loads (built first if missing)."""
    return _load() is not None


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


# ---------------------------------------------------------------------------
# blosclite: the c-blosc1-compatible LZ4(+byte-shuffle) frame codec, the
# zstd decoder and the CRC-32C that zarrlite's chunk codecs use.
# ---------------------------------------------------------------------------


def _load_blosc():
    global _blosc_lib, _blosc_tried
    with _lock:
        if _blosc_tried:
            return _blosc_lib
        _blosc_tried = True
        if not _ensure_built(_BLOSC_LIB_PATH, ("blosclite.cpp", "zstdlite.cpp", "zstdlite.h")):
            return None
        try:
            lib = ctypes.CDLL(_BLOSC_LIB_PATH)
        except OSError:
            return None
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.blosclite_nbytes.argtypes = [ctypes.c_char_p, i64]
        lib.blosclite_nbytes.restype = i64
        lib.blosclite_decompress.argtypes = [ctypes.c_char_p, i64, u8p, i64]
        lib.blosclite_decompress.restype = i64
        lib.blosclite_max_csize.argtypes = [i64]
        lib.blosclite_max_csize.restype = i64
        lib.blosclite_compress.argtypes = [ctypes.c_char_p, i64, i32, i32, u8p, i64]
        lib.blosclite_compress.restype = i64
        lib.zstdlite_decompress.argtypes = [ctypes.c_char_p, i64, u8p, i64]
        lib.zstdlite_decompress.restype = i64
        lib.zstdlite_content_size.argtypes = [ctypes.c_char_p, i64]
        lib.zstdlite_content_size.restype = i64
        lib.blosclite_crc32c.argtypes = [ctypes.c_char_p, i64]
        lib.blosclite_crc32c.restype = i64
        _blosc_lib = lib
        return _blosc_lib


def blosc_available() -> bool:
    return _load_blosc() is not None


def _blosc_raise(code: int) -> None:
    if code == -2:
        raise ValueError(
            "unsupported blosc feature (inner codec other than lz4/lz4hc, "
            "bitshuffle, or delta filter)"
        )
    raise ValueError("malformed blosc frame")


def _blosc_or_raise(what: str):
    lib = _load_blosc()
    if lib is None:
        raise ValueError(
            f"{what} but the native blosclite library is unavailable "
            "(build it with `make -C native`)"
        )
    return lib


def blosc_decompress(buf: bytes) -> bytes:
    """Decode one c-blosc1 frame (LZ4/LZ4HC inner codec) to raw bytes."""
    lib = _blosc_or_raise("blosc-compressed data")
    nbytes = lib.blosclite_nbytes(buf, len(buf))
    if nbytes < 0:
        _blosc_raise(nbytes)
    out = np.empty(nbytes, dtype=np.uint8)
    rc = lib.blosclite_decompress(buf, len(buf), out, nbytes)
    if rc < 0:
        _blosc_raise(rc)
    return out.tobytes()


def blosc_compress(buf: bytes, typesize: int = 1, shuffle: int = 1) -> bytes:
    """Encode raw bytes as a c-blosc1 LZ4 frame (optionally byte-shuffled)."""
    lib = _blosc_or_raise("blosc compression asked for")
    if len(buf) > 0x7FFFFFFF - 16:
        raise ValueError(
            "buffer too large for a blosc frame (c-blosc caps buffers at "
            "2**31-1 bytes incl. overhead); chunk the array before compressing"
        )
    cap = lib.blosclite_max_csize(len(buf))
    out = np.empty(cap, dtype=np.uint8)
    rc = lib.blosclite_compress(buf, len(buf), int(typesize), int(shuffle), out, cap)
    if rc < 0:
        _blosc_raise(rc)
    return out[:rc].tobytes()


def crc32c(data: bytes) -> int | None:
    """CRC-32C (Castagnoli) by the native library; ``None`` when it is
    unavailable (:mod:`.zarrlite` then uses its pure-python table)."""
    lib = _load_blosc()
    if lib is None:
        return None
    return int(lib.blosclite_crc32c(data, len(data))) & 0xFFFFFFFF


def zstd_decompress(buf: bytes, nbytes: int | None = None) -> bytes:
    """Decode one (or concatenated) zstd frame(s) by the RFC 8878 decoder
    in ``native/zstdlite.cpp`` (decode only).  ``nbytes`` is the decoded
    size; without it the frame header's content size is used."""
    lib = _blosc_or_raise("zstd-compressed data")
    if nbytes is None:
        nbytes = lib.zstdlite_content_size(buf, len(buf))
        if nbytes < 0:
            raise ValueError(
                "zstd frame does not declare its content size; pass the "
                "expected decoded size explicitly"
            )
    out = np.empty(nbytes, dtype=np.uint8)
    rc = lib.zstdlite_decompress(buf, len(buf), out, nbytes)
    if rc < 0:
        if rc == -2:
            raise ValueError("unsupported zstd feature (external dictionary)")
        raise ValueError("malformed zstd frame (or decoded size mismatch)")
    return out.tobytes()
