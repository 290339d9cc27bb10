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
notes there for what bounds it on the H100); anything else raises.
``LAUNCHES`` counts kernel launches by name, and only kernel launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..ops.keys import from_ordered_int, to_ordered_int
from . import build

__all__ = [
    "COUNT_SORT_MAX_LEN",
    "LAUNCHES",
    "count_sort_segments",
    "count_sort_segments_plain",
    "rank_map_segments",
    "rank_map_segments_plain",
]

# longest segment K1 takes: its O(L^2) compares per segment beat a general
# sort only for short segments; callers sort longer ones with torch.sort
COUNT_SORT_MAX_LEN = 256

LAUNCHES: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only), load and declare ``csrc/rank_map.cu``."""
    lib = build.load("rank_map")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sdt_count_sort_segments.argtypes = [vp, vp, i64, i32, vp]
    lib.sdt_count_sort_segments.restype = i32
    lib.sdt_rank_map_segments.argtypes = [vp, vp, vp, i64, i32, vp]
    lib.sdt_rank_map_segments.restype = i32
    lib.sdt_error_string.argtypes = [i32]
    lib.sdt_error_string.restype = ctypes.c_char_p
    return lib


def _segments(x: torch.Tensor, L: int) -> int:
    """Number of length-``L`` segments of a 2-D ``(B, G*L)`` tensor."""
    if x.dim() != 2 or L <= 0 or x.shape[1] % L:
        raise ValueError(f"expected a (B, G*L) tensor with L={L}, got shape {tuple(x.shape)}")
    return x.shape[0] * (x.shape[1] // L)


def _on_kernel(*ts: torch.Tensor) -> bool:
    """True for CUDA float32 (kernel), False for CPU (plain); raises else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda" or any(t.dtype != torch.float32 for t in ts):
        raise TypeError(
            f"the CUDA kernel takes float32 tensors on a CUDA device, got "
            f"{[t.dtype for t in ts]} on {dev}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    return True


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.sdt_error_string(rc).decode()} ({rc})")


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
    if not _on_kernel(x):
        return count_sort_segments_plain(x, L)
    if L > COUNT_SORT_MAX_LEN:
        raise ValueError(f"count_sort_segments takes L <= {COUNT_SORT_MAX_LEN}, got {L}")
    out = torch.empty_like(x)
    if n_seg == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sdt_count_sort_segments(x.data_ptr(), out.data_ptr(), n_seg, L, stream)
    _check(lib, rc, "count_sort_segments")
    LAUNCHES["count_sort_segments"] += 1
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
    rank-indexed result (run-end ties, NaN passthrough)."""
    n_seg = _segments(xq, L)
    if res.shape != xq.shape:
        raise ValueError(f"res shape {tuple(res.shape)} != xq shape {tuple(xq.shape)}")
    if not _on_kernel(xq, res):
        return rank_map_segments_plain(xq, res, L)
    out = torch.empty_like(xq)
    if n_seg == 0:
        return out
    lib = _lib()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        rc = lib.sdt_rank_map_segments(
            xq.data_ptr(), res.data_ptr(), out.data_ptr(), n_seg, L, stream
        )
    _check(lib, rc, "rank_map_segments")
    LAUNCHES["rank_map_segments"] += 1
    return out
