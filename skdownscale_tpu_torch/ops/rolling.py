"""Centered rolling statistics: the BCSD climate trend and the z-score
windows.

Port of ``skdownscale_tpu/ops/rolling.py``.  The windowed sums
(:func:`_window_sum`, :func:`rolling_sum_count`, :func:`rolling_mean`,
:func:`rolling_std`, :func:`rolling_mean_std`) add the ``w`` taps of one
padded buffer in ascending window offset, as the JAX form does, so on the
CPU in float64 they give the JAX package's bits.  :func:`rolling_mean_std`
(the 31-day z-score windows, ``zscore.py:267-269``) takes a banded block
form on CUDA float32 rows of at least 4 blocks: two ``(B, B)`` 0/1 band
products a block (:func:`_window_sums_matmul`, TF32 off), which reads each
element twice where the slice form reads it ``w`` times, and sums each
output afresh, so no cumsum cancellation enters.

The 9-point centered monthly climate-trend mean of the reference
(``bcsd.py:246-250``, ``rolling(9, center=True, min_periods=1).mean()``)
within each group comes in two forms that give the same map:

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
    "rolling_mean",
    "rolling_std",
    "rolling_mean_std",
    "rolling_sum_count",
    "use_stats_matmul",
    "grouped_rolling_matrix",
    "rolling_mean_grouped_flat",
    "rolling_mean_grouped_matmul",
    "use_rolling_matmul",
]

# the dense (n, n) matrix is only worth it while it and its FLOPs stay small
# (monthly T=480: 0.9 MB in float32; daily T=7305 would be 213 MB)
_MATMUL_MAX_N = 2048


def _window_bounds(window: int, center: bool = True):
    """Window offsets ``[lo, hi]`` and width: pandas ``center=True`` covers
    ``[i - w//2, i + (w-1)//2]``, a trailing window ``[i - w + 1, i]``."""
    lo, hi = (-(window // 2), (window - 1) // 2) if center else (-(window - 1), 0)
    return lo, hi, hi - lo + 1


def _window_sum(x, window: int, center: bool):
    """Sum over a trailing (or centered) window of the last axis: ``w``
    slices of one zero-padded buffer added in ascending window offset (the
    JAX form's order).  Each output is a fresh ``w``-term sum, so no cumsum
    cancellation enters."""
    n = x.shape[-1]
    lo, hi, w = _window_bounds(window, center)
    xp = F.pad(x, (-lo, hi))
    s = torch.zeros_like(x)
    for j in range(w):
        s = s + xp[..., j : j + n]
    return s


def rolling_sum_count(x, valid, window: int, center: bool = True):
    """Windowed sum of ``x*valid`` and windowed count of ``valid``.

    ``valid=None`` means every entry is valid: the count then depends only
    on the position along the window axis, so it is computed on one
    ``(n,)`` vector and broadcast."""
    if valid is None:
        c = _window_sum(torch.ones(x.shape[-1:], dtype=x.dtype, device=x.device), window, center)
        return _window_sum(x, window, center), c.broadcast_to(x.shape)
    v = valid.to(x.dtype)
    return _window_sum(x * v, window, center), _window_sum(v, window, center)


def rolling_mean(x, window: int, *, center: bool = True, min_periods: int | None = None, valid=None):
    """Centered rolling mean with pandas ``min_periods`` semantics: fewer
    than ``min_periods`` valid points in the window give NaN (pandas'
    default ``min_periods=window``)."""
    mp = window if min_periods is None else min_periods
    s, c = rolling_sum_count(x, valid, window, center)
    mean = s / torch.where(c > 0, c, 1)
    return torch.where(c >= mp, mean, float("nan"))


def rolling_std(
    x, window: int, *, center: bool = True, min_periods: int | None = None, ddof: int = 1, valid=None
):
    """Centered rolling standard deviation (pandas default ``ddof=1``), from
    the windowed sums of ``x`` and ``x*x``."""
    mp = window if min_periods is None else min_periods
    s, c = rolling_sum_count(x, valid, window, center)
    mean = s / torch.where(c > 0, c, 1)
    s2, _ = rolling_sum_count(x * x, valid, window, center)
    ss = s2 - 2 * mean * s + c * mean * mean
    var = ss.clamp(min=0.0) / (c - ddof).clamp(min=1)
    return torch.where((c >= mp) & (c > ddof), torch.sqrt(var), float("nan"))


# one output block of the banded form reads its own input block and the next
_STATS_BLOCK = 128


def use_stats_matmul(x: torch.Tensor, window: int) -> bool:
    """The banded block form runs on CUDA float32 rows of at least four
    blocks whose window fits one neighbour block (``w - 1 <= 128``); the CPU
    float64 parity path, and everything else, takes the slice form."""
    n = x.shape[-1]
    return (x.is_cuda and x.dtype == torch.float32
            and window <= _STATS_BLOCK + 1 and n >= 4 * _STATS_BLOCK)


@functools.lru_cache(maxsize=32)
def _stats_band_weights_host(window: int, center: bool):
    """Host ``(B, B)`` 0/1 band matrices ``(W0, W1)`` with
    ``y[kB + t] = (xb[k] @ W0)[t] + (xb[k+1] @ W1)[t]``, ``xb`` the
    non-overlapping B-blocks of the zero-padded input and ``y`` the windowed
    sum."""
    _, _, w = _window_bounds(window, center)
    B = _STATS_BLOCK
    u = np.arange(B)[:, None]
    t = np.arange(B)[None, :]
    W0 = ((t <= u) & (u <= t + w - 1)).astype(np.float64)
    W1 = ((t <= u + B) & (u + B <= t + w - 1)).astype(np.float64)
    return W0, W1


@functools.lru_cache(maxsize=32)
def _stats_band_weights(window: int, center: bool, device, dtype):
    return tuple(torch.as_tensor(W, dtype=dtype).to(device)
                 for W in _stats_band_weights_host(window, center))


def _window_sums_matmul(planes, window: int, center: bool):
    """Windowed sum of each row of ``planes`` (..., n) by two banded
    ``(B, B)`` products a block: ``y_k = xb_k @ W0 + xb_{k+1} @ W1``.
    Both products read the same blocked buffer; the shift by one block is
    taken on their outputs."""
    n = planes.shape[-1]
    lo, _, _ = _window_bounds(window, center)
    B = _STATS_BLOCK
    k_out = -(-n // B)
    xp = F.pad(planes, (-lo, k_out * B + B - (-lo + n)))
    xb = xp.reshape(*planes.shape[:-1], k_out + 1, B)
    w0, w1 = _stats_band_weights(window, center, planes.device, planes.dtype)
    y = (xb @ w0)[..., :k_out, :]
    y += (xb @ w1)[..., 1:, :]
    return y.reshape(*planes.shape[:-1], k_out * B)[..., :n]


def rolling_mean_std(
    x, window: int, *, center: bool = True, min_periods: int | None = None, ddof: int = 1
):
    """Centered rolling mean AND std in one pass, sharing the windowed sums.
    pandas semantics: ``min_periods`` defaults to ``window`` (NaN edges), a
    NaN input poisons every window it touches, ``ddof=1`` by default
    (``zscore.py:267-269``).

    Each row is centred on its nanmean before squaring (``mu0``): raw
    squares of ~283 K temperatures are ~8e4 against a windowed variance of a
    few K^2, which float32 would cancel.  On CUDA float32 long rows
    (:func:`use_stats_matmul`) the sums of ``x``, ``x*x`` and the NaN count
    take the banded block form; elsewhere the slice form, in the JAX
    package's order.
    """
    mp = window if min_periods is None else min_periods
    n = x.shape[-1]
    mu0 = torch.nanmean(x, dim=-1, keepdim=True)
    xm = x - mu0
    poison = None
    if use_stats_matmul(x, window):
        nanmask = torch.isnan(x)
        xc = torch.where(nanmask, 0.0, xm)
        del xm
        # one operand at a time: a stacked (3, C, n) operand would hold three
        # padded buffers and products at once
        s = _window_sums_matmul(xc, window, center)
        s2 = _window_sums_matmul(xc * xc, window, center)
        del xc
        poison = _window_sums_matmul(nanmask.to(x.dtype), window, center) > 0.5
    else:
        s = _window_sum(xm, window, center)
        s2 = _window_sum(xm * xm, window, center)
    # the positional window count (every entry counts): a function of (n, window)
    c = _window_sum(torch.ones((n,), dtype=x.dtype, device=x.device), window, center)
    cc = torch.where(c > 0, c, 1)
    mean_raw = s / cc
    ss = s2 - 2 * mean_raw * s + c * mean_raw * mean_raw
    var = ss.clamp(min=0.0) / (c - ddof).clamp(min=1)
    std_raw = torch.sqrt(var)
    bad_mean = c < mp
    bad_std = (c < mp) | (c <= ddof)
    if poison is not None:
        bad_mean = bad_mean | poison
        bad_std = bad_std | poison
    mean = torch.where(bad_mean, float("nan"), mean_raw + mu0)
    std = torch.where(bad_std, float("nan"), std_raw)
    return mean, std


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
