"""Group-bounded centered rolling mean (the BCSD climate trend).

Port of the grouped part of ``skdownscale_tpu/ops/rolling.py``: the 9-point
centered monthly climate-trend mean of the reference (``bcsd.py:246-250``,
``rolling(9, center=True, min_periods=1).mean()``) within each group, in two
forms that give the same map:

* :func:`rolling_mean_grouped_flat`: ``w`` shifted adds of one padded
  buffer.  It sums the values before it divides, so on quantized (tied)
  inputs it is exact in any order and keeps the ties of the JAX package's
  CPU path bit for bit.  It runs on the CPU (float64 parity).
* :func:`rolling_mean_grouped_matmul`: the whole gather -> masked rolling
  mean -> inverse-permutation scatter as one host-built ``(n, n)`` matrix,
  one float32 GEMM on the card (TF32 off).  It multiplies by ``1/count``
  first, which is not exact, so it is only taken on CUDA float32.

:func:`use_rolling_matmul` chooses between them from the tensor it is given.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "grouped_rolling_matrix",
    "rolling_mean_grouped_flat",
    "rolling_mean_grouped_matmul",
    "use_rolling_matmul",
]

# the dense (n, n) matrix is only worth it while it and its FLOPs stay small
# (monthly T=480: 0.9 MB in float32; daily T=7305 would be 213 MB)
_MATMUL_MAX_N = 2048


def _window_bounds(window: int):
    """pandas ``center=True`` window offsets ``[lo, hi]`` and width."""
    lo = -(window // 2)
    hi = (window - 1) // 2
    return lo, hi, hi - lo + 1


@functools.lru_cache(maxsize=64)
def _flat_tables_host(valid_bytes: bytes, shape: tuple, window: int, min_periods: int):
    valid = np.frombuffer(valid_bytes, dtype=bool).reshape(shape).copy()
    G, L = shape
    n = G * L
    lo, _, w = _window_bounds(window)
    pos = np.arange(n)
    vflat = valid.reshape(-1)
    seg = np.zeros((w, n), np.float64)
    cnt = np.zeros(n, np.float64)
    for j in range(w):
        src = pos + lo + j
        ok = (src >= 0) & (src < n) & ((src // L) == (pos // L))
        seg[j, ok] = 1.0
        cnt[ok] += vflat[np.clip(src, 0, n - 1)][ok]
    denom = np.where(cnt > 0, cnt, 1.0)
    keep = (cnt >= min_periods) & vflat
    return vflat, seg, denom, keep


@functools.lru_cache(maxsize=64)
def _flat_tables(valid_bytes, shape, window, min_periods, device, dtype):
    vflat, seg, denom, keep = _flat_tables_host(valid_bytes, shape, window, min_periods)
    return (
        torch.as_tensor(vflat, dtype=dtype).to(device),
        torch.as_tensor(seg, dtype=dtype).to(device),
        torch.as_tensor(denom, dtype=dtype).to(device),
        torch.as_tensor(keep).to(device),
    )


def rolling_mean_grouped_flat(x_flat, window: int, valid: np.ndarray, *, min_periods: int = 1):
    """Per-group centered rolling mean on a FLAT ``(..., G*L)`` layout.

    Group boundaries are enforced by host-precomputed per-offset segment
    masks (a window term is kept only when it stays inside the source
    position's group); the valid-count/min_periods bookkeeping is host-side.
    The adds run in ascending window offset, as in the JAX package, so the
    result is bitwise the JAX CPU path's.  Padding slots return 0.

    ``valid``: host (G, L) bool mask of real entries (prefix masks).
    """
    valid = np.ascontiguousarray(valid, dtype=bool)
    n = valid.size
    lo, hi, w = _window_bounds(window)
    vflat, seg, denom, keep = _flat_tables(
        valid.tobytes(), valid.shape, window, min_periods, x_flat.device, x_flat.dtype
    )
    xp = F.pad(x_flat * vflat, (-lo, hi))
    s = torch.zeros_like(x_flat)
    for j in range(w):
        s = s + xp[..., j : j + n] * seg[j]
    return torch.where(keep, s / denom, torch.zeros_like(s))


@functools.lru_cache(maxsize=64)
def grouped_rolling_matrix(groups, window: int, n: int, min_periods: int = 1) -> np.ndarray | None:
    """Host ``(n, n)`` matrix ``R`` with ``R @ x == scatter_groups(
    rolling_mean_grouped_flat(gather_groups(x, groups, fill=0.0), window,
    groups.mask, min_periods=min_periods), groups, n)`` for a PARTITION
    grouping of ``[0, n)``.  Returns None when the grouping is not an exact
    partition of ``[0, n)``."""
    G, L = groups.mask.shape
    idx = groups.indices.reshape(-1).astype(np.int64)
    msk = groups.mask.reshape(-1)
    flatN = G * L
    tgt = idx[msk]
    if tgt.size != n or not np.array_equal(np.sort(tgt), np.arange(n)):
        return None
    lo, _, w = _window_bounds(window)
    pos = np.arange(flatN)
    R_flat = np.zeros((flatN, n), np.float64)
    cnt = np.zeros(flatN, np.float64)
    for j in range(w):
        src = pos + lo + j
        ok = (src >= 0) & (src < flatN) & ((src // L) == (pos // L))
        oksrc = src[ok]
        vsrc = msk[oksrc]
        rows = pos[ok][vsrc]
        np.add.at(R_flat, (rows, idx[oksrc][vsrc]), 1.0)
        cnt[pos[ok][vsrc]] += 1.0
    denom = np.where(cnt > 0, cnt, 1.0)
    keep = (cnt >= min_periods) & msk
    R_flat = np.where(keep[:, None], R_flat / denom[:, None], 0.0)
    inv = np.zeros(n, np.int64)
    inv[tgt] = np.nonzero(msk)[0]
    return np.ascontiguousarray(R_flat[inv])


@functools.lru_cache(maxsize=64)
def _rolling_matrix_t(groups, window: int, n: int, device, dtype):
    R = grouped_rolling_matrix(groups, window, n)
    if R is None:
        return None
    return torch.as_tensor(np.ascontiguousarray(R.T), dtype=dtype).to(device)


def rolling_mean_grouped_matmul(x, groups, window: int):
    """The grouped rolling mean of ``x`` (..., n) as ``x @ R.T`` with the
    cached device copy of :func:`grouped_rolling_matrix`; None when
    ``groups`` is not a partition of ``[0, n)``."""
    Rt = _rolling_matrix_t(groups, window, x.shape[-1], x.device, x.dtype)
    return None if Rt is None else x @ Rt


def use_rolling_matmul(x: torch.Tensor) -> bool:
    """The matrix form runs on CUDA float32 (as it ran on the TPU in
    float32); everything else, the CPU float64 parity path included, takes
    the flat form, which keeps ties exact."""
    return x.is_cuda and x.dtype == torch.float32 and x.shape[-1] <= _MATMUL_MAX_N
