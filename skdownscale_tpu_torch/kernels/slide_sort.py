"""Sliding sorted window (K5): wrapper, plain PyTorch version and launch
count.

:func:`slide_sorted_windows` returns, for each cell of ``y`` (..., T) and
each consulted window ``i`` of a :class:`~..models.slide.SlidePlan`, the
window's member values in ascending order of their order-isomorphic keys
(-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN), FLAT: window ``i``
occupies columns ``[i*Lto, (i+1)*Lto)`` of a (..., n_rows*Lto) tensor.  The
first ``count_i`` slots hold the values, +inf the rest; rows past the last
window (up to ``n_rows``, which lets a caller pad to its chunk grid) are all
+inf.  A key equal to the integer pad key (the pad itself, or the NaN whose
bits are all ones) comes out as +inf.  It replaces ``slide_sorted_windows``
of ``skdownscale_tpu/ops/pallas/slide_sort_kernel.py``.

Interior NaN: the TPU kernel (and so this one) sorts NaN members of a
window before the window's pad slots, because pads carry the integer pad
key, above every float key.  The JAX package's CPU route instead pads with
+inf before it sorts, which puts a NaN member after the pads.  The port
follows the kernel's rule on every device: its CPU route runs the plain
version below.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA float32
tensor launches the hand-written kernel of ``csrc/slide_sort.cu`` (see the
notes there); anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.keys import from_ordered_int, to_ordered_int
from . import LAUNCHES, build, check_launch, on_kernel

__all__ = ["LAUNCHES", "launch_geometry", "slide_sorted_windows", "slide_sorted_windows_plain"]


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/slide_sort.cu``."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sdt_slide_sorted_windows.argtypes = [
        vp, i64, i64, vp, i32, vp, vp, i32, i32, i32, i32, vp, vp,
    ]
    lib.sdt_slide_sorted_windows.restype = i32
    lib.sdt_slide_geometry.argtypes = [i32, i32, vp]
    lib.sdt_slide_geometry.restype = i32
    lib.sdt_error_string.argtypes = [i32]
    lib.sdt_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only) and load ``csrc/slide_sort.cu``."""
    return declare(build.load("slide_sort"))


GEOMETRY_KEYS = ("block_route", "threads", "cells_per_block", "smem_bytes", "blocks_per_sm",
                 "items")


def launch_geometry(plan, lib: ctypes.CDLL | None = None) -> dict:
    """The launch K5 (or another build of it, ``lib``) takes for ``plan`` on
    the current card, launching nothing: whether a cell takes a block
    (windows above 1,024 keys) or a warp, threads and cells a block, shared
    bytes a block, resident blocks an SM and window-0 keys a lane.  Needs
    the card."""
    lib = lib or _lib()
    res = (ctypes.c_int * len(GEOMETRY_KEYS))()
    rc = lib.sdt_slide_geometry(len(plan.w0_idx), plan.add_idx.shape[1], ctypes.addressof(res))
    check_launch(lib, rc, "slide_sorted_windows")
    return dict(zip(GEOMETRY_KEYS, res))


def _n_rows(plan, n_rows: int | None, T: int) -> int:
    """Output rows, after checking the plan against a length-``T`` series."""
    S = len(plan.consulted)
    if n_rows is None:
        n_rows = S
    if n_rows < S:
        raise ValueError(f"n_rows={n_rows} does not cover the plan's {S} windows")
    top = max(int(plan.w0_idx.max()), int(plan.add_idx.max()), int(plan.rem_idx.max()))
    if top >= T:
        raise ValueError(f"the plan indexes time step {top} of a series of {T}")
    return n_rows


@functools.lru_cache(maxsize=16)
def _window_members(plan) -> np.ndarray:
    """Host (n_windows, Lto) member table of every consulted window, -1
    padded, rebuilt from the plan's window 0 and step tables."""
    cur = set(plan.w0_idx[plan.w0_idx >= 0].tolist())
    rows = [sorted(cur)]
    for add, rem in zip(plan.add_idx, plan.rem_idx):
        cur = (cur - set(rem[rem >= 0].tolist())) | set(add[add >= 0].tolist())
        rows.append(sorted(cur))
    table = np.full((len(rows), plan.Lto), -1, np.int64)
    for i, r in enumerate(rows):
        table[i, : len(r)] = r
    return table


@functools.lru_cache(maxsize=16)
def _members_dev(plan, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_window_members(plan)).to(device)


@functools.lru_cache(maxsize=16)
def _plan_dev(plan, device: torch.device):
    """The plan's int32 tables on ``device``, for the kernel."""

    def i(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return i(plan.w0_idx), i(plan.add_idx), i(plan.rem_idx)


def slide_sorted_windows_plain(y: torch.Tensor, plan, *, n_rows: int | None = None) -> torch.Tensor:
    """Plain version of K5, float32 or float64: gather each window's member
    keys, fill the pad slots with the integer pad key (not +inf, so that a
    NaN member sorts before them), ``torch.sort`` the keys, then map the pad
    key to +inf."""
    T = y.shape[-1]
    rows = _n_rows(plan, n_rows, T)
    lead = y.shape[:-1]
    keys = to_ordered_int(y.reshape(-1, T))
    pad = torch.iinfo(keys.dtype).max
    inf_key = to_ordered_int(torch.tensor([float("inf")], dtype=y.dtype))[0].item()
    idx = _members_dev(plan, y.device)  # (S, Lto)
    S, Lto = idx.shape
    k = keys.index_select(-1, idx.clamp(min=0).reshape(-1)).reshape(-1, S, Lto)
    k = torch.where(idx < 0, pad, k)
    k = torch.sort(k, dim=-1).values
    if rows > S:
        k = torch.cat([k, k.new_full((k.shape[0], rows - S, Lto), pad)], dim=1)
    k = torch.where(k == pad, inf_key, k)
    return from_ordered_int(k, y.dtype).reshape(*lead, rows * Lto)


def slide_sorted_windows(y: torch.Tensor, plan, *, n_rows: int | None = None) -> torch.Tensor:
    """K5: sorted values of every consulted window of ``plan``, flat
    (..., n_rows*Lto): by the CUDA kernel for a CUDA float32 tensor, by the
    plain version for a CPU tensor."""
    if not on_kernel(y):
        return slide_sorted_windows_plain(y, plan, n_rows=n_rows)
    T = y.shape[-1]
    rows = _n_rows(plan, n_rows, T)
    lead = y.shape[:-1]
    y2 = y.reshape(-1, T)
    if y2.shape[0] == 0:
        return y.new_empty((*lead, rows * plan.Lto))
    out = launch(_lib(), y2, plan, rows)
    LAUNCHES["slide_sorted_windows"] += 1
    return out.reshape(*lead, rows * plan.Lto)


def launch(lib: ctypes.CDLL, y2: torch.Tensor, plan, rows: int) -> torch.Tensor:
    """One launch of a build of the kernel on checked (C, T) CUDA float32
    rows, C > 0: the (C, rows * Lto) output.  Counts nothing."""
    C, T = y2.shape
    out = torch.empty((C, rows * plan.Lto), dtype=y2.dtype, device=y2.device)
    w0, add, rem = _plan_dev(plan, y2.device)
    with torch.cuda.device(y2.device):
        stream = torch.cuda.current_stream(y2.device).cuda_stream
        rc = lib.sdt_slide_sorted_windows(
            y2.data_ptr(), C, T, w0.data_ptr(), w0.shape[0], add.data_ptr(), rem.data_ptr(),
            add.shape[1], len(plan.consulted), plan.Lto, rows, out.data_ptr(), stream,
        )
    check_launch(lib, rc, "slide_sorted_windows")
    return out
