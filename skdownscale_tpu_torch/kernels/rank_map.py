"""Segment count-sort (K1) and segment rank-map (K2): wrappers, plain
PyTorch versions and launch counts.

Both operate on a ``(B, G*L)`` tensor cut into contiguous length-``L``
segments of the minor axis (``G = 1`` is the one-segment-per-row form).

* K1 :func:`count_sort_segments` sorts each segment, bitwise in the
  total order -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.  It replaces
  ``count_sort_segments`` and ``count_sort_rows`` of
  ``skdownscale_tpu/ops/pallas/rank_map_kernel.py``.
* K2 :func:`rank_map_segments` computes ``out[b, g*L+t] = res[b, g*L +
  rank_t]`` with ``rank_t = #{s in segment : xq_s <= xq_t} - 1`` (float
  compares: run-end rank on ties, NaN query -> NaN).  It replaces
  ``rank_map_segments`` and ``rank_map_rows`` of the same file.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA float32
tensor launches the hand-written kernel of ``csrc/rank_map.cu`` (see the
notes there for its routes and what bounds them on the H100); anything
else raises.  The kernel's launcher picks a route by ``L`` before any
launch, as :func:`route` does: ``"packed"`` (whole segments packed end to
end, four keys a thread, ``L <= SHORT_MAX[kernel]``), ``"warp"`` (a warp a
segment: the radix sort of ``csrc/radix_sort.cuh``, and for K2 a run-end
fill, ``L <= 1,024``), ``"block"`` (a block a segment, K2 up to 16,384)
and ``"search"`` (K2 above: chunks sorted into a device-memory scratch
row, then a search a query).  ``LAUNCHES`` (shared by every kernel of the
package) counts kernel launches by name, and only kernel launches: one a
wrapper call, whatever the route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.keys import from_ordered_int, to_ordered_int
from . import LAUNCHES, build, check_launch, on_kernel

__all__ = [
    "COUNT_SORT_MAX_LEN",
    "LAUNCHES",
    "ROUTES",
    "count_sort_segments",
    "count_sort_segments_plain",
    "launch_geometry",
    "rank_map_segments",
    "rank_map_segments_plain",
    "route",
]

# longest segment K1 takes; callers sort longer ones with the row sort K9
COUNT_SORT_MAX_LEN = 256

# the kernel's routes by length (csrc/rank_map.cu), in its numbering
ROUTES = ("packed", "warp", "block", "search")
# longest L of each kernel's packed route
SHORT_MAX = {"count_sort_segments": 64, "rank_map_segments": 256}
WARP_MAX = 1024  # longest L of the warp route
BLOCK_MAX = 16384  # longest L of K2's block route

_KERNEL_ID = {"count_sort_segments": 1, "rank_map_segments": 2}


def route(kernel: str, L: int) -> str:
    """The route the default build of the kernel ``kernel``
    (``"count_sort_segments"`` or ``"rank_map_segments"``) takes for
    segments of length ``L``; what ``sdt_rank_map_route`` returns."""
    too_long = kernel == "count_sort_segments" and L > COUNT_SORT_MAX_LEN
    if kernel not in _KERNEL_ID or L <= 0 or too_long:
        raise ValueError(f"{kernel} does not take L={L}")
    if L <= SHORT_MAX[kernel]:
        return "packed"
    if L <= WARP_MAX or kernel == "count_sort_segments":
        return "warp"
    return "block" if L <= BLOCK_MAX else "search"


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/rank_map.cu``."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sdt_count_sort_segments.argtypes = [vp, vp, i64, i32, vp]
    lib.sdt_count_sort_segments.restype = i32
    lib.sdt_rank_map_segments.argtypes = [vp, vp, vp, vp, i64, i32, vp]
    lib.sdt_rank_map_segments.restype = i32
    lib.sdt_rank_map_route.argtypes = [i32, i32]
    lib.sdt_rank_map_route.restype = i32
    lib.sdt_rank_map_geometry.argtypes = [i32, i32, vp]
    lib.sdt_rank_map_geometry.restype = i32
    lib.sdt_error_string.argtypes = [i32]
    lib.sdt_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only) and load ``csrc/rank_map.cu``."""
    return declare(build.load("rank_map"))


GEOMETRY_KEYS = ("route", "threads", "items", "smem_bytes", "blocks_per_sm")


def launch_geometry(kernel: str, L: int, lib: ctypes.CDLL | None = None) -> dict:
    """The launch the kernel ``kernel`` (or another build of it, ``lib``)
    takes for length ``L`` on the current card, launching nothing: its
    route, threads a block, keys a lane (or a thread, on the packed
    route), shared bytes a block and resident blocks an SM (of the first
    kernel, on the search route).  Needs the card."""
    lib = lib or _lib()
    res = (ctypes.c_int * len(GEOMETRY_KEYS))()
    rc = lib.sdt_rank_map_geometry(_KERNEL_ID[kernel], L, ctypes.addressof(res))
    check_launch(lib, rc, kernel)
    geo = dict(zip(GEOMETRY_KEYS, res))
    geo["route"] = ROUTES[geo["route"]]
    return geo


def _segments(x: torch.Tensor, L: int) -> int:
    """Number of length-``L`` segments of a 2-D ``(B, G*L)`` tensor."""
    if x.dim() != 2 or L <= 0 or x.shape[1] % L:
        raise ValueError(f"expected a (B, G*L) tensor with L={L}, got shape {tuple(x.shape)}")
    return x.shape[0] * (x.shape[1] // L)


# ----------------------------------------------------------------------
# K1: segment count-sort
# ----------------------------------------------------------------------


def count_sort_segments_plain(x: torch.Tensor, L: int) -> torch.Tensor:
    """Sort each length-``L`` segment of ``x`` (B, G*L) by its
    order-isomorphic integer keys (``torch.sort`` on floats treats -0 == +0
    and puts every NaN last, so it is not this order).  Float32 or float64,
    any ``L``."""
    B = x.shape[0]
    _segments(x, L)
    k = to_ordered_int(x).reshape(B, -1, L)
    return from_ordered_int(torch.sort(k, dim=-1).values, x.dtype).reshape(x.shape)


def count_sort_segments(x: torch.Tensor, L: int) -> torch.Tensor:
    """K1: sort each length-``L`` segment of ``x`` (B, G*L): by the CUDA
    kernel for a CUDA float32 tensor (``L <= COUNT_SORT_MAX_LEN``), by the
    plain version for a CPU tensor."""
    n_seg = _segments(x, L)
    if not on_kernel(x):
        return count_sort_segments_plain(x, L)
    if L > COUNT_SORT_MAX_LEN:
        raise ValueError(f"count_sort_segments takes L <= {COUNT_SORT_MAX_LEN}, got {L}")
    if n_seg == 0:
        return torch.empty_like(x)
    out = launch_count_sort(_lib(), x, L)
    LAUNCHES["count_sort_segments"] += 1
    return out


def launch_count_sort(lib: ctypes.CDLL, x: torch.Tensor, L: int) -> torch.Tensor:
    """One launch of a build of K1 on checked CUDA float32 segments (at
    least one): the sorted segments.  Counts nothing."""
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sdt_count_sort_segments(x.data_ptr(), out.data_ptr(), _segments(x, L), L, stream)
    check_launch(lib, rc, "count_sort_segments")
    return out


# ----------------------------------------------------------------------
# K2: segment rank-map
# ----------------------------------------------------------------------


def rank_map_segments_plain(xq: torch.Tensor, res: torch.Tensor, L: int) -> torch.Tensor:
    """Plain version of K2, float32 or float64: the count
    ``#{s : xq_s <= xq_t}`` is a right-sided ``searchsorted`` into the
    segment's sorted keys, with -0 folded onto +0 and every NaN keyed above
    +inf so that no query counts it."""
    _segments(xq, L)
    if res.shape != xq.shape:
        raise ValueError(f"res shape {tuple(res.shape)} != xq shape {tuple(xq.shape)}")
    q = xq.reshape(-1, L)
    isnan = torch.isnan(q)
    k = to_ordered_int(torch.where(q == 0, torch.zeros_like(q), q))
    k = torch.where(isnan, torch.full_like(k, torch.iinfo(k.dtype).max), k)
    rank = torch.searchsorted(torch.sort(k, dim=-1).values, k, right=True) - 1
    out = torch.gather(res.reshape(-1, L), 1, rank.clamp(min=0))
    return torch.where(isnan, torch.full_like(out, float("nan")), out).reshape(xq.shape)


def rank_map_segments(xq: torch.Tensor, res: torch.Tensor, L: int) -> torch.Tensor:
    """K2: rank each query within its length-``L`` segment and take the
    rank-indexed result (run-end ties, NaN passthrough): by the CUDA kernel
    for a CUDA float32 tensor, at any ``L``, by the plain version for a CPU
    tensor."""
    n_seg = _segments(xq, L)
    if res.shape != xq.shape:
        raise ValueError(f"res shape {tuple(res.shape)} != xq shape {tuple(xq.shape)}")
    if not on_kernel(xq, res):
        return rank_map_segments_plain(xq, res, L)
    if n_seg == 0:
        return torch.empty_like(xq)
    out = launch_rank_map(_lib(), xq, res, L)
    LAUNCHES["rank_map_segments"] += 1
    return out


def launch_rank_map(lib: ctypes.CDLL, xq: torch.Tensor, res: torch.Tensor, L: int) -> torch.Tensor:
    """One launch of a build of K2 on checked CUDA float32 segments (at
    least one), with the device-memory scratch row of the search route
    where the build takes it for this ``L``: the mapped values.  Counts
    nothing."""
    n_seg = _segments(xq, L)
    out = torch.empty_like(xq)
    scratch = None
    if ROUTES[lib.sdt_rank_map_route(2, L)] == "search":
        scratch = torch.empty(xq.shape, dtype=torch.int32, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = lib.sdt_rank_map_segments(
            xq.data_ptr(), res.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n_seg, L, stream,
        )
    check_launch(lib, rc, "rank_map_segments")
    return out
