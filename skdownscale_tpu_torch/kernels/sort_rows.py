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
hand-written kernel of ``csrc/sort_rows.cu`` (see the notes there) at any
row length, by the route :func:`sort_route` names: rows up to
:data:`K9_SMEM_MAX` are sorted in one block's shared memory, rows up to
55,296 in a thread-block cluster's, longer rows through a device-memory
workspace that the wrapper allocates on the caller's stream; anything else
raises.  :data:`ROUTE_LAUNCHES` counts each form's launches by route.
Callers reach K9 through :func:`on_rows`.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..ops.keys import from_ordered_int, to_ordered_int
from . import LAUNCHES, build, check_launch, on_kernel
from .rank_map import count_sort_segments_plain

__all__ = [
    "K9_MAX_LEN",
    "K9_SMEM_MAX",
    "LAUNCHES",
    "ROUTE_LAUNCHES",
    "on_rows",
    "sort_rows",
    "sort_rows_plain",
    "sort_rows_with_positions",
    "sort_rows_with_positions_plain",
    "sort_route",
    "unsort_rows",
    "unsort_rows_plain",
    "unsort_route",
]

# longest row sorted with its items in registers between passes (a warp or
# a block a row, the row's keys and positions in shared memory, 48 KB at
# 8,192); longer rows take the routes of :func:`sort_route`, which walk the
# row in tiles between two buffers
K9_MAX_LEN = 8192

# the rule of ``csrc/sort_rows.cu`` (kSmemLimit, kSmemWarps, kSmemItems,
# kClusterWarps, kClusterItems, kClusterMin, kClusterMax, kMisc, kUnsortWarpMax,
# kUnsortBlockMax): the shared memory a block may use, the warps a block
# and items a lane of the shared-memory and cluster routes, a cluster's
# most blocks, and the unsort's route edges
SMEM_LIMIT = 232_448
SMEM_WARPS, SMEM_ITEMS = 32, 12
CLUSTER_WARPS, CLUSTER_ITEMS = 24, 18
CLUSTER_TILE = CLUSTER_WARPS * CLUSTER_ITEMS * 32
CLUSTER_MAX, CLUSTER_MIN = 4, 2
_MISC_WORDS = 48
UNSORT_WARP_MAX, UNSORT_BLOCK_MAX = 1024, SMEM_LIMIT // 4

# the sort's routes and the unsort's, by the codes ``sdt_sort_route`` and
# ``sdt_unsort_route`` return
SORT_ROUTES = ("warp", "block", "smem", "cluster", "device")
UNSORT_ROUTES = ("warp", "block", "scatter")


def _align16(n: int) -> int:
    return (n + 15) & ~15


def row_smem_bytes(n: int, warps: int, with_positions: bool) -> int:
    """Shared memory of a block of ``warps`` warps holding ``n`` elements
    on the shared-memory or cluster route: counters, each pass's offsets,
    the group sums and bits, two key buffers and (with positions) two
    16-bit position buffers (``row_smem_bytes`` of the source)."""
    header = (warps * 256 + 4 * 256 + _MISC_WORDS) * 4
    return header + 2 * _align16(4 * n) + (2 * _align16(2 * n) if with_positions else 0)


def row_capacity(warps: int, with_positions: bool) -> int:
    """The most elements such a block holds in :data:`SMEM_LIMIT` bytes."""
    n = (SMEM_LIMIT - row_smem_bytes(0, warps, with_positions)) // (12 if with_positions else 8)
    while row_smem_bytes(n + 1, warps, with_positions) <= SMEM_LIMIT:
        n += 1
    while row_smem_bytes(n, warps, with_positions) > SMEM_LIMIT:
        n -= 1
    return n


# longest row sorted in one block's shared memory, by form (with positions
# or not): 16,280 and 24,424
K9_SMEM_MAX = {wp: row_capacity(SMEM_WARPS, wp) for wp in (False, True)}


def cluster_size(L: int) -> int:
    """The cluster route's blocks a row at ``L``: the least number, at least
    two, whose blocks each hold one tile (:data:`CLUSTER_TILE`, 13,824) of
    the row."""
    return max(CLUSTER_MIN, -(-L // CLUSTER_TILE))


def sort_route(L: int, with_positions: bool, lib: ctypes.CDLL | None = None) -> str:
    """The route K9's sort (with positions or not) takes at row length
    ``L``: ``warp``, ``block``, ``smem`` (a block's shared memory),
    ``cluster`` or ``device`` (device memory).  Without ``lib`` the rule of
    the source in plain Python (no build, no card); with it, what that
    build of the library takes (asked once for each ``L`` and form)."""
    if lib is not None:
        return _built_sort_route(lib, L, with_positions)
    if L <= 1024:
        return "warp"
    if L <= K9_MAX_LEN:
        return "block"
    if L <= K9_SMEM_MAX[with_positions]:
        return "smem"
    if cluster_size(L) <= CLUSTER_MAX:
        return "cluster"
    return "device"


@functools.lru_cache(maxsize=None)
def _built_sort_route(lib: ctypes.CDLL, L: int, with_positions: bool) -> str:
    return SORT_ROUTES[lib.sdt_sort_route(L, int(with_positions), None)]


@functools.lru_cache(maxsize=None)
def _built_unsort_route(lib: ctypes.CDLL, L: int) -> str:
    return UNSORT_ROUTES[lib.sdt_unsort_route(L)]


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/sort_rows.cu``."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sdt_sort_rows.argtypes = [vp, vp, vp, i64, i32, vp]
    lib.sdt_sort_rows.restype = i32
    lib.sdt_sort_rows_with_positions.argtypes = [vp, vp, vp, vp, i64, i32, vp]
    lib.sdt_sort_rows_with_positions.restype = i32
    lib.sdt_unsort_rows.argtypes = [vp, vp, vp, i64, i32, vp]
    lib.sdt_unsort_rows.restype = i32
    lib.sdt_unsort_route.argtypes = [i32]
    lib.sdt_unsort_route.restype = i32
    lib.sdt_sort_route.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.sdt_sort_route.restype = i32
    lib.sdt_error_string.argtypes = [i32]
    lib.sdt_error_string.restype = ctypes.c_char_p
    return lib


# launches of each form by route, (form, route): the breakdown of LAUNCHES
ROUTE_LAUNCHES: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only) and load ``csrc/sort_rows.cu``."""
    return declare(build.load("sort_rows"))


def unsort_route(L: int, lib: ctypes.CDLL | None = None) -> str:
    """The route K9's unsort takes at row length ``L``: ``warp``, ``block``
    (a row of floats in a block's shared memory) or ``scatter``.  Without
    ``lib`` the rule of the source in plain Python; with it, what that build
    of the library takes (asked once for each ``L``)."""
    if lib is not None:
        return _built_unsort_route(lib, L)
    return "warp" if L <= UNSORT_WARP_MAX else "block" if L <= UNSORT_BLOCK_MAX else "scatter"


def built_cluster_size(L: int, with_positions: bool, lib: ctypes.CDLL) -> int:
    """The blocks a row that build ``lib`` takes at ``L`` (0 off the
    cluster route)."""
    c = ctypes.c_int(0)
    lib.sdt_sort_route(L, int(with_positions), ctypes.byref(c))
    return c.value


def _rows(x: torch.Tensor) -> tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"expected (B, L) rows, got shape {tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def _on(device: torch.device, launch):
    """``launch(stream)`` with ``device``'s current CUDA stream as a raw
    handle, ``device`` made current first where it is not (the C entry
    points launch on the current device).  The raw handle spares a Stream
    object a call: at monthly rows the unsort's kernel is shorter than the
    host's part of a call."""
    if torch.cuda.current_device() != device.index:
        with torch.cuda.device(device):
            return launch(torch._C._cuda_getCurrentRawStream(device.index))
    return launch(torch._C._cuda_getCurrentRawStream(device.index))


def launch_sort(lib: ctypes.CDLL, x: torch.Tensor, with_positions: bool):
    """One launch of a build of the sort (with positions) on a checked,
    non-empty contiguous CUDA float32 ``(B, L)`` tensor: the sorted rows
    (and int32 positions).  Rows on the device-memory route get their
    workspace here, on the current stream.  Counts nothing."""
    B, L = x.shape
    out = torch.empty_like(x)
    pos = torch.empty(x.shape, dtype=torch.int32, device=x.device) if with_positions else None
    work = None
    if L > K9_MAX_LEN and sort_route(L, with_positions, lib) == "device":
        work = torch.empty((2 if with_positions else 1, B, L), dtype=torch.int32, device=x.device)
    wp = 0 if work is None else work.data_ptr()
    if with_positions:
        rc = _on(x.device, lambda s: lib.sdt_sort_rows_with_positions(
            x.data_ptr(), out.data_ptr(), pos.data_ptr(), wp, B, L, s))
    else:
        rc = _on(x.device, lambda s: lib.sdt_sort_rows(x.data_ptr(), out.data_ptr(), wp, B, L, s))
    check_launch(lib, rc, "sort_rows_with_positions" if with_positions else "sort_rows")
    return (out, pos) if with_positions else out


def launch_unsort(lib: ctypes.CDLL, vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One launch of a build of the unsort on checked, non-empty CUDA
    arguments.  Counts nothing."""
    B, L = vals.shape
    out = torch.empty_like(vals)
    rc = _on(vals.device, lambda s: lib.sdt_unsort_rows(vals.data_ptr(), pos.data_ptr(),
                                                        out.data_ptr(), B, L, s))
    check_launch(lib, rc, "unsort_rows")
    return out


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
    if not (B and L):
        return torch.empty_like(x)
    lib = _lib()
    out = launch_sort(lib, x, False)
    LAUNCHES["sort_rows"] += 1
    ROUTE_LAUNCHES["sort_rows", sort_route(L, False, lib)] += 1
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
    if not (B and L):
        return torch.empty_like(x), torch.empty(x.shape, dtype=torch.int32, device=x.device)
    lib = _lib()
    out = launch_sort(lib, x, True)
    LAUNCHES["sort_rows_with_positions"] += 1
    ROUTE_LAUNCHES["sort_rows_with_positions", sort_route(L, True, lib)] += 1
    return out


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
    if pos.dtype != torch.int32 or not pos.is_contiguous():
        raise TypeError(f"the CUDA kernel takes contiguous int32 positions, got {pos.dtype}")
    if not (B and L):
        return torch.empty_like(vals)
    lib = _lib()
    out = launch_unsort(lib, vals, pos)
    LAUNCHES["unsort_rows"] += 1
    ROUTE_LAUNCHES["unsort_rows", unsort_route(L, lib)] += 1
    return out


def on_rows(form: str, *ts: torch.Tensor):
    """K9 form ``form`` (``"sort_rows"``, ``"sort_rows_with_positions"`` or
    ``"unsort_rows"``) on ``(..., L)`` tensors through their contiguous
    ``(rows, L)`` view, the outputs back with the leading dims.  The form
    launches the kernel at every ``L`` on the card."""
    lead, L = ts[0].shape[:-1], ts[0].shape[-1]
    out = globals()[form](*(t.reshape(-1, L).contiguous() for t in ts))
    if isinstance(out, tuple):
        return tuple(o.reshape(*lead, L) for o in out)
    return out.reshape(*lead, L)
