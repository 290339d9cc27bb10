"""Batched monotone-table interpolation (K6): wrapper, plain PyTorch version
and launch count.

:func:`batched_interp` computes ``out[b, i] = interp(q[b, i], xp[b], fp[b])``
on monotone non-decreasing rows (ragged rows padded per
:func:`~..ops.interp.pad_table`: ``+inf`` knots, the last valid ``fp``), in
the semantics of ``interp_ramp`` (``skdownscale_tpu/ops/interp.py``):
np.interp with clamped ends, ties resolved to the last tied knot, the value
evaluated from the nearer bracketing knot, ``x0``/``x1`` clipped to
``+-big`` and ``f1`` above at ``big = finfo.max / 8``.  It replaces
``batched_interp`` of ``skdownscale_tpu/ops/pallas/interp_kernel.py``.

Each of ``xp``, ``fp`` and ``q`` is a 2-D tensor of either ``B`` rows or
one row; a one-row argument is shared by every output row (a row stride of
0 in the kernel), so a plotting-position vector is never copied per cell.

NaN: a NaN query gives the query itself.  A row whose ``xp`` or ``fp``
holds a NaN gives NaN for every non-NaN query that the end clamps
(``q < xp[0]``, ``q > xp[-1]``) do not catch, as ``interp_ramp``'s
reductions carry the NaN into every bracket.  (The TPU kernel's min-update
skips a NaN knot instead; the port follows ``interp_ramp``.)

Dispatch: a tensor on the CPU goes to the plain version; CUDA float32
tensors launch the hand-written kernel of ``csrc/interp.cu`` (see the notes
there); anything else raises.  Rows of at least :data:`LONG_ROW_MIN` knots
take the kernel's long-row route (:func:`long_row`): a grid-wide NaN scan,
then the searches spread over the card, two launches of one K6 call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, build, check_launch, on_kernel

__all__ = ["LAUNCHES", "LONG_ROW_MIN", "batched_interp", "batched_interp_plain", "launch_geometry",
           "long_row"]

# SDT_K6_LONG_MIN of csrc/interp.cu: rows of at least this many knots take
# the long-row route (config G's pooled ladder, one row of 2.4e8 knots; mesh
# G's merged sketch row of 32,768, faster there than a block a row)
LONG_ROW_MIN = 32768


def long_row(L: int) -> bool:
    """Whether rows of ``L`` knots take K6's long-row route, by length
    alone (the other routes' choice reads the card).  Needs no card."""
    return L >= LONG_ROW_MIN


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/interp.cu``."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sdt_batched_interp.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i64, i64, i64, vp]
    lib.sdt_batched_interp.restype = i32
    lib.sdt_interp_long_min.argtypes = []
    lib.sdt_interp_long_min.restype = i32
    lib.sdt_interp_geometry.argtypes = [i64, i32, i32, i32, i32, i32, vp]
    lib.sdt_interp_geometry.restype = i32
    lib.sdt_error_string.argtypes = [i32]
    lib.sdt_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only) and load ``csrc/interp.cu``."""
    return declare(build.load("interp"))


GEOMETRY_KEYS = ("route", "threads", "smem_bytes", "blocks_per_sm", "grid")
ROUTES = ("device memory", "staged", "long row")


def launch_geometry(xp: torch.Tensor, fp: torch.Tensor, q: torch.Tensor,
                    lib: ctypes.CDLL | None = None) -> dict:
    """The launch K6 (or another build of it, ``lib``) takes for these
    arguments on the current card, launching nothing: its route
    (``staged`` in shared memory, ``device memory`` or ``long row``; and
    ``staged`` as a bool), threads a block, shared bytes a block, resident
    blocks an SM and blocks in the grid (on the long-row route: the NaN
    scan's blocks an SM and the search's grid).  Needs the card."""
    B = _out_rows(xp, fp, q)
    lib = lib or _lib()
    res = (ctypes.c_int64 * len(GEOMETRY_KEYS))()
    rc = lib.sdt_interp_geometry(B, xp.shape[1], q.shape[1], int(xp.shape[0] == 1),
                                 int(fp.shape[0] == 1), int(q.shape[0] == 1), ctypes.addressof(res))
    check_launch(lib, rc, "batched_interp")
    geo = dict(zip(GEOMETRY_KEYS, res))
    geo["route"] = ROUTES[geo["route"]]
    geo["staged"] = geo["route"] == "staged"
    return geo


@functools.lru_cache(maxsize=None)
def _long_min(lib: ctypes.CDLL) -> int:
    """SDT_K6_LONG_MIN of a build (0: no long-row route)."""
    return lib.sdt_interp_long_min()


def _out_rows(xp: torch.Tensor, fp: torch.Tensor, q: torch.Tensor) -> int:
    """Output rows after checking shapes: each argument has 1 or B rows."""
    if xp.dim() != 2 or fp.dim() != 2 or q.dim() != 2:
        raise ValueError(
            f"expected 2-D xp, fp, q, got {tuple(xp.shape)}, {tuple(fp.shape)}, {tuple(q.shape)}"
        )
    if xp.shape[1] != fp.shape[1] or xp.shape[1] == 0:
        raise ValueError(f"xp and fp need the same non-zero length, got {xp.shape[1]} and {fp.shape[1]}")
    rows = {t.shape[0] for t in (xp, fp, q)} - {1}
    if len(rows) > 1:
        raise ValueError(f"row counts {xp.shape[0]}, {fp.shape[0]}, {q.shape[0]} do not broadcast")
    return rows.pop() if rows else 1


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[b, idx[b, i]]`` with a one-row ``t`` shared by every row of idx."""
    if t.shape[0] == 1:
        return t[0][idx]
    return torch.gather(t, 1, idx)


def batched_interp_plain(xp: torch.Tensor, fp: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6, any float dtype and device.

    The bracket count ``#{l : xp[l] <= q}`` is a right-sided
    ``torch.searchsorted`` (1-D boundaries for a shared table), so no
    (B, Q, L) intermediate is formed; the knots on each side are gathered
    with ``-inf``/``+inf`` where there is none, as ``interp_ramp``'s masked
    reductions give.  Each operation of the closed form is its own kernel,
    so no FMA forms."""
    B = _out_rows(xp, fp, q)
    L, Q = xp.shape[1], q.shape[1]
    dtype = q.dtype
    inf = float("inf")
    big = torch.finfo(dtype).max / 8
    qb = q.expand(B, Q)
    if xp.shape[0] == 1:
        c = torch.searchsorted(xp[0].contiguous(), qb.contiguous(), right=True)
    else:
        c = torch.searchsorted(xp.contiguous(), qb.contiguous(), right=True)
    lo = (c - 1).clamp(min=0)
    hi = c.clamp(max=L - 1)
    has_lo, has_hi = c > 0, c < L
    x0 = torch.where(has_lo, _take(xp, lo), -inf)
    f0 = torch.where(has_lo, _take(fp, lo), -inf)
    x1 = torch.where(has_hi, _take(xp, hi), inf)
    f1 = torch.where(has_hi, _take(fp, hi), inf)
    x0 = x0.clamp(-big, big)
    x1 = x1.clamp(-big, big)
    f1 = f1.clamp(max=big)
    dx = x1 - x0
    nonzero = dx != 0
    slope = (f1 - f0) / torch.where(nonzero, dx, 1.0)
    slope = torch.where(nonzero, slope, 0.0)
    use_right = (qb - x0) > (x1 - qb)
    res = torch.where(use_right, f1 + (qb - x1) * slope, f0 + (qb - x0) * slope)
    row_nan = (torch.isnan(xp).any(dim=1) | torch.isnan(fp).any(dim=1))[:, None]
    res = torch.where(row_nan, float("nan"), res)
    res = torch.where(qb < xp[:, :1], fp[:, :1], res)
    res = torch.where(qb > xp[:, -1:], fp[:, -1:], res)
    return torch.where(torch.isnan(qb), qb, res)


def batched_interp(xp: torch.Tensor, fp: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K6: row-batched interp of ``q`` (B|1, Q) against the tables ``xp``,
    ``fp`` (B|1, L) -> (B, Q): by the CUDA kernel for CUDA float32
    tensors, by the plain version for CPU tensors."""
    B = _out_rows(xp, fp, q)
    if not on_kernel(xp, fp, q):
        return batched_interp_plain(xp, fp, q)
    if B == 0 or q.shape[1] == 0:
        return q.new_empty((B, q.shape[1]))
    out = launch(_lib(), xp, fp, q)
    LAUNCHES["batched_interp"] += 1
    return out


def launch(lib: ctypes.CDLL, xp: torch.Tensor, fp: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """One launch of a build of the kernel on checked CUDA float32
    arguments with rows and queries: the (B, Q) output.  Counts nothing."""
    B = _out_rows(xp, fp, q)
    L, Q = xp.shape[1], q.shape[1]
    out = torch.empty((B, Q), dtype=q.dtype, device=q.device)

    def stride(t):
        return 0 if t.shape[0] == 1 else t.stride(0)

    long_min = _long_min(lib)
    # the long-row route's NaN flags: one a row and one for the shared tables
    flags = torch.zeros(B + 1, dtype=torch.int32, device=q.device) if 0 < long_min <= L else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sdt_batched_interp(
            xp.data_ptr(), fp.data_ptr(), q.data_ptr(), out.data_ptr(),
            0 if flags is None else flags.data_ptr(),
            B, L, Q, stride(xp), stride(fp), stride(q), stream,
        )
    check_launch(lib, rc, "batched_interp")
    return out
