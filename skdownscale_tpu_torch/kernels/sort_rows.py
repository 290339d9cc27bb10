"""Row sort, stable row sort with positions, and unsort (K9): wrappers,
plain PyTorch versions and launch counts.

All three work on ``(B, L)`` rows and replace ``sort_rows``,
``sort_rows_with_positions`` and ``unsort_rows`` of
``skdownscale_tpu/ops/pallas/sort_kernel.py``:

* :func:`sort_rows` sorts each row in the total order of the
  order-isomorphic keys (``ops/keys.py``),
  -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN, bitwise.  This is the
  TPU kernel's order; JAX's CPU ``lax.sort`` instead treats -0 as equal to
  +0, and the port follows the kernel (MBCn's rotated data has no signed
  zeros, and its grid masks non-finite cells).
* :func:`sort_rows_with_positions` also returns each sorted element's
  original position (int32).  The sort is STABLE: ties keep their input
  order, the order ``lax.sort(..., is_stable=True)`` gives, which is one of
  the orders the TPU kernel allows (it leaves tie order unspecified).
* :func:`unsort_rows` puts ``vals`` back in original order, given the
  positions of such a sort (a permutation of each row): ``out[b, pos[b,
  i]] = vals[b, i]``.

Dispatch: a tensor on the CPU goes to the plain version (float32 or
float64); a contiguous CUDA float32 tensor (int32 positions) launches the
hand-written kernel of ``csrc/sort_rows.cu`` (see the notes there), for
rows up to :data:`K9_MAX_LEN`; anything else raises.  Callers reach K9
through :func:`on_rows`, which sends longer rows to the plain version by
shape before any launch, as K1's callers do above ``COUNT_SORT_MAX_LEN``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.keys import from_ordered_int, to_ordered_int
from . import LAUNCHES, build, check_launch, on_kernel
from .rank_map import count_sort_segments_plain

__all__ = [
    "K9_MAX_LEN",
    "LAUNCHES",
    "on_rows",
    "sort_rows",
    "sort_rows_plain",
    "sort_rows_with_positions",
    "sort_rows_with_positions_plain",
    "unsort_rows",
    "unsort_rows_plain",
]

# longest row the kernel takes: positions travel as 16-bit payloads, and a
# block holds its row's keys and positions in shared memory, 48 KB at 8,192
# (of the 227 KB a block may use); that covers 10 and 20 years of daily data
# (3,650, 7,305)
K9_MAX_LEN = 8192


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only), load and declare ``csrc/sort_rows.cu``."""
    lib = build.load("sort_rows")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sdt_sort_rows.argtypes = [vp, vp, i64, i32, vp]
    lib.sdt_sort_rows.restype = i32
    lib.sdt_sort_rows_with_positions.argtypes = [vp, vp, vp, i64, i32, vp]
    lib.sdt_sort_rows_with_positions.restype = i32
    lib.sdt_unsort_rows.argtypes = [vp, vp, vp, i64, i32, vp]
    lib.sdt_unsort_rows.restype = i32
    lib.sdt_error_string.argtypes = [i32]
    lib.sdt_error_string.restype = ctypes.c_char_p
    return lib


def _rows(x: torch.Tensor) -> tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"expected (B, L) rows, got shape {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def _kernel_len(L: int) -> None:
    if L > K9_MAX_LEN:
        raise ValueError(f"the K9 kernel takes rows of L <= {K9_MAX_LEN}, got {L}")


def _launch(entry, name: str, device, *args) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    check_launch(lib, rc, name)
    LAUNCHES[name] += 1


def sort_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` (B, L) sorted by its order-isomorphic keys: K1's
    plain version with one segment a row; float32 or float64."""
    _rows(x)
    return count_sort_segments_plain(x, x.shape[1])


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """K9: each row of ``x`` (B, L) sorted, bitwise as :func:`sort_rows_plain`."""
    B, L = _rows(x)
    if not on_kernel(x):
        return sort_rows_plain(x)
    _kernel_len(L)
    out = torch.empty_like(x)
    if B and L:
        _launch("sdt_sort_rows", "sort_rows", x.device, x.data_ptr(), out.data_ptr(), B, L)
    return out


def sort_rows_with_positions_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted rows, int32 original positions) by a stable sort of the keys."""
    _rows(x)
    s = torch.sort(to_ordered_int(x), dim=-1, stable=True)
    return from_ordered_int(s.values, x.dtype), s.indices.to(torch.int32)


def sort_rows_with_positions(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K9 with positions: (sorted rows, int32 positions), bitwise as
    :func:`sort_rows_with_positions_plain`."""
    B, L = _rows(x)
    if not on_kernel(x):
        return sort_rows_with_positions_plain(x)
    _kernel_len(L)
    out = torch.empty_like(x)
    pos = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if B and L:
        _launch("sdt_sort_rows_with_positions", "sort_rows_with_positions", x.device,
                x.data_ptr(), out.data_ptr(), pos.data_ptr(), B, L)
    return out, pos


def _check_pos(vals: torch.Tensor, pos: torch.Tensor) -> None:
    if pos.shape != vals.shape:
        raise ValueError(f"pos shape {tuple(pos.shape)} != vals shape {tuple(vals.shape)}")
    if pos.device != vals.device:
        raise ValueError(f"pos on {pos.device}, vals on {vals.device}")


def unsort_rows_plain(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``out[b, pos[b, i]] = vals[b, i]``: a scatter by the positions."""
    _rows(vals)
    _check_pos(vals, pos)
    return torch.empty_like(vals).scatter_(-1, pos.long(), vals)


def unsort_rows(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K9 unsort: ``vals`` (B, L) back in original order by ``pos`` (B, L),
    a permutation of each row (int32 on the card)."""
    B, L = _rows(vals)
    _check_pos(vals, pos)
    if not on_kernel(vals):
        return unsort_rows_plain(vals, pos)
    _kernel_len(L)
    if pos.dtype != torch.int32 or not pos.is_contiguous():
        raise TypeError(f"the CUDA kernel takes contiguous int32 positions, got {pos.dtype}")
    out = torch.empty_like(vals)
    if B and L:
        _launch("sdt_unsort_rows", "unsort_rows", vals.device,
                vals.data_ptr(), pos.data_ptr(), out.data_ptr(), B, L)
    return out


def on_rows(form: str, *ts: torch.Tensor):
    """K9 form ``form`` (``"sort_rows"``, ``"sort_rows_with_positions"`` or
    ``"unsort_rows"``) on ``(..., L)`` tensors through their contiguous
    ``(rows, L)`` view, the outputs back with the leading dims.  Rows longer
    than :data:`K9_MAX_LEN` take the form's plain version: a shape route,
    taken before any launch."""
    lead, L = ts[0].shape[:-1], ts[0].shape[-1]
    fn = globals()[form if L <= K9_MAX_LEN else f"{form}_plain"]
    out = fn(*(t.reshape(-1, L).contiguous() for t in ts))
    if isinstance(out, tuple):
        return tuple(o.reshape(*lead, L) for o in out)
    return out.reshape(*lead, L)
