"""Spatial and temporal disaggregation (the "SD" in BCSD).

Port of ``skdownscale_tpu/utils/disagg.py``:

1. interpolate coarse bias-corrected anomalies onto the fine grid and apply
   a fine-scale monthly climatology, additive for temperature and
   multiplicative for precipitation (:func:`spatial_disaggregate`);
2. distribute monthly values over the days of each month with the daily
   observed climatology's within-month pattern, Wood et al. (2004)
   (:func:`temporal_disaggregate`, :func:`bcsd_disaggregator`).

The calendar and membership tables are host numpy, equal to the JAX
package's bitwise; the device work is matrix products (full float32 on a
card, TF32 off as the package sets) and elementwise combines.

:func:`interp_to_fine` computes what the JAX package's
``jax.image.resize`` computes (antialiased scale-and-translate with the
triangle, Keys cubic (a = -0.5) and Lanczos kernels; nearest by
half-pixel centres), from per-axis weight matrices built on the host and
applied as two products, as :func:`regrid_separable` does.

Arrays given to these functions go to ``device`` (the card unless the
caller passes ``"cpu"``; float32 there); tensors stay where they are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .device import as_tensor
from .timeindex import TimeIndex

__all__ = [
    "interp_to_fine",
    "regrid_weights_1d",
    "regrid_separable",
    "apply_climatology",
    "spatial_disaggregate",
    "temporal_disaggregate",
    "bcsd_disaggregator",
    "daily_index_for_months",
]


def regrid_weights_1d(src_coords, dst_coords) -> np.ndarray:
    """Host ``(D, S)`` linear-interpolation weight matrix along one axis.

    Row ``i`` holds the two bracketing weights of ``dst_coords[i]`` in the
    strictly-increasing ``src_coords`` (np.interp semantics: clamp beyond
    the ends).  Rows sum to 1, so applying the matrix is a mean-preserving
    matmul, for non-uniform grids (real latitude spacings, Gaussian grids).
    """
    src = np.asarray(src_coords, dtype=np.float64)
    dst = np.asarray(dst_coords, dtype=np.float64)
    if src.ndim != 1 or len(src) < 2 or (np.diff(src) <= 0).any():
        raise ValueError("src_coords must be 1-D, length >= 2, strictly increasing")
    hi = np.clip(np.searchsorted(src, dst, side="left"), 1, len(src) - 1)
    lo = hi - 1
    w = (dst - src[lo]) / (src[hi] - src[lo])
    w = np.clip(w, 0.0, 1.0)
    out = np.zeros((len(dst), len(src)), dtype=np.float64)
    rows = np.arange(len(dst))
    out[rows, lo] = 1.0 - w
    out[rows, hi] += w
    return out


def regrid_separable(data, wy, wx):
    """Coordinate-based bilinear regrid of (..., ny, nx) fields: two
    separable products ``wy @ data @ wx.T`` batched over leading dims (the
    weights from :func:`regrid_weights_1d` per axis; rows sum to 1)."""
    wy = torch.as_tensor(np.asarray(wy), dtype=data.dtype, device=data.device)
    wx = torch.as_tensor(np.asarray(wx), dtype=data.dtype, device=data.device)
    return wy @ (data @ wx.T)


# ---------------------------------------------------------------------------
# interp_to_fine: jax.image.resize's weights, built on the host
# ---------------------------------------------------------------------------


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _lanczos(radius, x):
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1.0), 1.0)
    return np.where(x > radius, 0.0, out)


_KERNELS = {
    "linear": _triangle,
    "lanczos3": functools.partial(_lanczos, 3.0),
    "lanczos5": functools.partial(_lanczos, 5.0),
    "cubic": _keys_cubic,
}
_ALIASES = {
    "nearest": "nearest",
    "linear": "linear", "bilinear": "linear", "trilinear": "linear", "triangle": "linear",
    "lanczos3": "lanczos3",
    "lanczos5": "lanczos5",
    "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic",
}


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) float64 weights of ``jax.image.resize`` along one axis
    (``compute_weight_mat`` with scale ``n_out / n_in``, no translation,
    antialiased: the kernel widens by ``n_in / n_out`` when downsampling)."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


@functools.lru_cache(maxsize=64)
def _nearest_rows(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each output along one axis: the half-pixel centre
    ``floor((i + 0.5) * n_in / n_out)``, in float32 as ``jax.image.resize``
    computes it."""
    f32 = np.float32
    offsets = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)
    return np.floor(offsets).astype(np.int64)


def _resize(x, shape, method: str):
    """``jax.image.resize(x, (*x.shape[:-2], *shape), method)`` on the last
    two axes; an axis whose size does not change is left as it is."""
    method = _ALIASES[method]
    for axis, n_out in ((-2, shape[0]), (-1, shape[1])):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":  # a gather: a one-hot product would spread NaN
            idx = torch.tensor(_nearest_rows(n_in, n_out), device=x.device)
            x = x.index_select(axis if axis >= 0 else x.ndim + axis, idx)
            continue
        w = torch.tensor(_resize_weights(n_in, n_out, method), dtype=x.dtype, device=x.device)
        x = x @ w if axis == -1 else w.T @ x
    return x


def interp_to_fine(coarse, shape, method: str = "bilinear", nan_aware: bool = False):
    """Resample (..., ny, nx) fields to ``shape=(NY, NX)`` (batched), as
    ``jax.image.resize`` does.

    With ``nan_aware=True``, NaN source cells (ocean/missing) are excluded
    by mask-renormalization, ``resize(x*m) / resize(m)``, so coastal fine
    cells take the weighted mean of their valid coarse neighbours instead
    of NaN; fine cells with no valid coverage (weight <= 1e-6) stay NaN.
    """
    if method not in _ALIASES:
        raise ValueError(f'Unknown resize method "{method}"')
    shape = tuple(int(n) for n in shape)
    if not nan_aware:
        return _resize(coarse, shape, method)
    valid = torch.isfinite(coarse)
    num = _resize(torch.where(valid, coarse, torch.zeros_like(coarse)), shape, method)
    den = _resize(valid.to(coarse.dtype), shape, method)
    ok = den > 1e-6
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.full_like(num, float("nan")))


def apply_climatology(anoms_fine, climo_fine, month_labels, *, kind: str = "temperature"):
    """Combine fine-grid anomalies with a fine-grid monthly climatology.

    ``anoms_fine``: (T, NY, NX); ``climo_fine``: (12, NY, NX) keyed by the
    per-step ``month_labels`` (T,) in 0..11.  Additive for ``'temperature'``,
    multiplicative for ``'precipitation'``.
    """
    labels = torch.as_tensor(np.asarray(month_labels), dtype=torch.long, device=climo_fine.device)
    climo_t = climo_fine[labels]  # (T, NY, NX)
    if kind == "temperature":
        return anoms_fine + climo_t
    if kind == "precipitation":
        return anoms_fine * climo_t
    raise ValueError(f"unknown kind: {kind}")


def spatial_disaggregate(
    anoms_coarse,
    climo_fine,
    month_labels,
    *,
    kind: str = "temperature",
    method: str = "bilinear",
    nan_aware: bool = False,
    device="cuda",
):
    """Full SD step: coarse anomalies -> fine grid -> climatology applied.

    Parameters
    ----------
    anoms_coarse : (T, ny, nx) bias-corrected anomalies (the output of a
        ``Bcsd*`` model with ``return_anoms=True`` over a grid).
    climo_fine : (12, NY, NX) fine-scale monthly climatology.
    month_labels : (T,) int month-1 labels for each time step.
    kind : 'temperature' (additive) or 'precipitation' (multiplicative).
    nan_aware : exclude NaN (ocean) coarse cells by mask-renormalized
        regridding instead of letting NaN spread to the coasts.
    device : where arrays go (tensors stay where they are).
    """
    anoms = as_tensor(anoms_coarse, device, "spatial_disaggregate")
    climo = as_tensor(climo_fine, anoms.device, "spatial_disaggregate")
    fine = interp_to_fine(anoms, climo.shape[-2:], method=method, nan_aware=nan_aware)
    return apply_climatology(fine, climo, month_labels, kind=kind)


# ---------------------------------------------------------------------------
# Temporal disaggregation (monthly -> daily), Wood et al. (2004):
#
#   temperature:    daily_t = monthly[m(t)] + pattern[doy(t)]
#   precipitation:  daily_t = monthly[m(t)] * pattern[doy(t)]
#
# where ``pattern`` is the across-years mean of the obs' within-month daily
# deviation (difference of, or ratio to, that (year, month)'s mean).  With
# ``conserve=True`` each output month is re-shifted / re-scaled so that its
# mean equals the input monthly value.  The calendar and group structure is
# host data (normalized membership matrices from ``TimeIndex``); the device
# computes three mean-pooling products and elementwise combines, batched
# over any trailing spatial dims.
# ---------------------------------------------------------------------------


def daily_index_for_months(monthly_index):
    """Host helper: the daily DatetimeIndex spanning a monthly index's months."""
    import pandas as pd

    idx = pd.DatetimeIndex(monthly_index)
    start = idx[0].replace(day=1)
    end = (idx[-1] + pd.offsets.MonthEnd(0)).normalize()
    return pd.date_range(start, end, freq="D")


def _month_ids(ti: TimeIndex):
    """(year, month) group ids: labels (n,) in [0, M) plus the (M, 2) keys."""
    keys = np.stack([ti.year, ti.month], axis=1)
    uniq, labels = np.unique(keys, axis=0, return_inverse=True)
    return labels.astype(np.int32), uniq


def _mean_matrix(labels: np.ndarray, n_groups: int) -> np.ndarray:
    """(n_groups, n) row-normalized membership matrix (rows mean-pool)."""
    n = len(labels)
    m = np.zeros((n_groups, n), dtype=np.float64)
    m[labels, np.arange(n)] = 1.0
    counts = m.sum(axis=1, keepdims=True)
    return m / np.maximum(counts, 1.0)


def _pool(mat, x):
    """``einsum("mt,t...->m...", mat, x)``: one product over the time axis."""
    return (mat @ x.reshape(x.shape[0], -1)).reshape(mat.shape[0], *x.shape[1:])


def _temporal_disagg_device(
    monthly,
    obs,
    obs_month_mean_mat,  # (Mo, To) mean over each obs (year, month)
    obs_month_labels,  # (To,) -> rows of obs_month_mean_mat
    doy_mean_mat,  # (D, To) mean over obs steps sharing a DOY
    doy_counts,  # (D,) how many obs steps back each DOY row
    midx_out,  # (Tout,) -> rows of `monthly`
    doy_out,  # (Tout,) -> rows of the DOY pattern
    out_month_mean_mat,  # (Tm, Tout) mean over each output month
    *,
    kind: str,
    conserve: bool,
):
    zero = torch.zeros((), dtype=obs.dtype, device=obs.device)
    # per-(year, month) obs means, broadcast back to each obs day
    mm_t = _pool(obs_month_mean_mat, obs)[obs_month_labels]
    if kind == "temperature":
        dev = obs - mm_t
    else:
        # all-dry months give 0/0 -> define the ratio as 0 (obs is 0 there)
        pos = mm_t > 0
        dev = torch.where(pos, obs / torch.where(pos, mm_t, torch.ones_like(mm_t)), zero)
    pattern = _pool(doy_mean_mat, dev)
    # DOYs absent from obs (e.g. leap day under a noleap record): neutral
    seen = (doy_counts > 0).reshape((-1,) + (1,) * (obs.ndim - 1))
    neutral = 0.0 if kind == "temperature" else 1.0
    pattern = torch.where(seen, pattern, torch.full((), neutral, dtype=obs.dtype, device=obs.device))

    base = monthly[midx_out]
    out = base + pattern[doy_out] if kind == "temperature" else base * pattern[doy_out]
    if conserve:
        mo = _pool(out_month_mean_mat, out)
        if kind == "temperature":
            out = out + (monthly - mo)[midx_out]
        else:
            # re-scale each month to the target mean; a month whose pattern
            # collapsed to zero mean cannot be rescaled -> distribute the
            # monthly value uniformly over its days instead
            safe = mo > 0
            scale = torch.where(safe, monthly / torch.where(safe, mo, torch.ones_like(mo)), zero)
            out = out * scale[midx_out] + torch.where(safe, zero, monthly)[midx_out]
    return out


def temporal_disaggregate(
    monthly,
    monthly_index,
    obs_daily,
    obs_index,
    out_index=None,
    *,
    kind: str = "temperature",
    conserve: bool = True,
    device="cuda",
):
    """Distribute monthly values over days using the obs daily climatology.

    Parameters
    ----------
    monthly : (Tm, ...) bias-corrected monthly series (any trailing spatial
        dims; e.g. the output of a gridded ``BcsdTemperature`` predict).
    monthly_index : DatetimeIndex / ``TimeIndex`` with one entry per month.
    obs_daily : (To, ...) daily observations on the same spatial layout.
    obs_index : daily DatetimeIndex / ``TimeIndex`` for ``obs_daily``.
    out_index : daily index for the output; defaults to the days spanning
        ``monthly_index``'s months (requires a pandas ``monthly_index``).
    kind : 'temperature' (additive pattern) or 'precipitation' (ratio).
    conserve : re-anchor each output month so its mean equals the monthly
        input exactly (the Wood et al. conservation property).
    device : where arrays go (tensors stay where they are).

    Every output (year, month) must appear in ``monthly_index``.
    """
    if kind not in ("temperature", "precipitation"):
        raise ValueError(f"unknown kind: {kind}")
    if out_index is None:
        out_index = daily_index_for_months(monthly_index)
    m_ti = TimeIndex.from_any(monthly_index)
    o_ti = TimeIndex.from_any(obs_index)
    t_ti = TimeIndex.from_any(out_index)

    obs_labels, _ = _month_ids(o_ti)
    n_obs_months = int(obs_labels.max()) + 1
    obs_mean = _mean_matrix(obs_labels, n_obs_months)

    n_doy = max(int(o_ti.dayofyear.max()), int(t_ti.dayofyear.max()))
    doy_labels = (o_ti.dayofyear - 1).astype(np.int32)
    doy_mean = _mean_matrix(doy_labels, n_doy)
    doy_counts = np.bincount(doy_labels, minlength=n_doy).astype(np.int32)

    # map output days onto rows of `monthly` via (year, month) keys
    m_keys = {(int(y), int(m)): i for i, (y, m) in enumerate(zip(m_ti.year, m_ti.month))}
    try:
        midx_out = np.asarray(
            [m_keys[(int(y), int(m))] for y, m in zip(t_ti.year, t_ti.month)], dtype=np.int32
        )
    except KeyError as e:
        raise ValueError(f"output month {e} missing from monthly_index") from None
    # conservation pools over *output* months but must scatter through the
    # monthly rows they map to, so build the matrix in monthly-row space
    out_mean = np.zeros((len(m_ti), len(t_ti)), dtype=np.float64)
    out_mean[midx_out, np.arange(len(t_ti))] = 1.0
    counts = out_mean.sum(axis=1, keepdims=True)
    out_mean = out_mean / np.maximum(counts, 1.0)

    monthly = as_tensor(monthly, device, "temporal_disaggregate")
    obs = as_tensor(obs_daily, monthly.device, "temporal_disaggregate")
    dev, dt = monthly.device, monthly.dtype

    def mat(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    def ids(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

    return _temporal_disagg_device(
        monthly,
        obs,
        mat(obs_mean),
        ids(obs_labels),
        mat(doy_mean),
        ids(doy_counts),
        ids(midx_out),
        ids((t_ti.dayofyear - 1).astype(np.int32)),
        mat(out_mean),
        kind=kind,
        conserve=conserve,
    )


def bcsd_disaggregator(downscaled, obs_daily, out_index=None, *, kind: str = "temperature",
                       device="cuda"):
    """The roadmap-named wrapper: ``bcsd_disaggregator(downscaled_temp,
    da_temp_obs_daily)`` on DataArrays (``xlite`` or real xarray) that carry
    a ``time`` coord; returns a DataArray of the same flavor, its values on
    the host.  Plain arrays take :func:`temporal_disaggregate`."""
    mi = downscaled.coords["time"] if hasattr(downscaled, "coords") else None
    oi = obs_daily.coords["time"] if hasattr(obs_daily, "coords") else None
    if mi is None or oi is None:
        raise TypeError("bcsd_disaggregator expects DataArray inputs with a 'time' coord")
    if out_index is None:
        out_index = daily_index_for_months(mi)
    vals = temporal_disaggregate(
        np.asarray(downscaled.data), mi, np.asarray(obs_daily.data), oi, out_index,
        kind=kind, device=device,
    ).cpu().numpy()
    if type(downscaled).__module__.startswith("xarray"):  # pragma: no cover - real-xarray images
        import xarray as xr

        coords = {d: downscaled.coords[d] for d in downscaled.dims if d != "time"}
        coords["time"] = out_index
        return xr.DataArray(vals, dims=downscaled.dims, coords=coords)
    from ..xlite import DataArray

    coords = dict(downscaled.coords)
    coords["time"] = out_index
    return DataArray(vals, downscaled.dims, coords)
