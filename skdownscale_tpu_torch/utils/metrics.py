"""Evaluation metrics for downscaling output, as reductions over the last
(time) axis of tensors.

Port of ``skdownscale_tpu/utils/metrics.py``: one call scores every grid
cell at once, skipping NaN (ocean cells, rolling edges) as the JAX package
does (:func:`_valid`).  Every function takes tensors on any device and
returns tensors there; :func:`validation_report` also takes arrays, which
go to the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.regression import ols_1d
from .device import as_tensor

__all__ = [
    "rmse",
    "mae",
    "bias",
    "pearsonr",
    "r2",
    "score_all",
    "ks_stat",
    "quantile_bias",
    "wet_day_freq_bias",
    "annual_cycle_rmse",
    "trend_bias",
    "energy_distance",
    "validation_report",
]


def _valid(y_true, y_pred):
    v = torch.isfinite(y_true) & torch.isfinite(y_pred)
    n = v.sum(dim=-1)
    return v, n.clamp(min=1), n


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def rmse(y_true, y_pred):
    """Root mean squared error over the last (time) axis, NaN-skipping."""
    v, n, _ = _valid(y_true, y_pred)
    se = torch.where(v, (y_true - y_pred) ** 2, _zero(y_true))
    return torch.sqrt(se.sum(dim=-1) / n)


def mae(y_true, y_pred):
    v, n, _ = _valid(y_true, y_pred)
    ae = torch.where(v, (y_true - y_pred).abs(), _zero(y_true))
    return ae.sum(dim=-1) / n


def bias(y_true, y_pred):
    """Mean error (pred - true)."""
    v, n, _ = _valid(y_true, y_pred)
    e = torch.where(v, y_pred - y_true, _zero(y_true))
    return e.sum(dim=-1) / n


def pearsonr(y_true, y_pred):
    v, n, _ = _valid(y_true, y_pred)
    zero = _zero(y_true)
    t = torch.where(v, y_true, zero)
    p = torch.where(v, y_pred, zero)
    tm = t.sum(dim=-1, keepdim=True) / n[..., None]
    pm = p.sum(dim=-1, keepdim=True) / n[..., None]
    td = torch.where(v, t - tm, zero)
    pd_ = torch.where(v, p - pm, zero)
    cov = (td * pd_).sum(dim=-1)
    denom = torch.sqrt((td * td).sum(dim=-1) * (pd_ * pd_).sum(dim=-1))
    return cov / torch.where(denom > 0, denom, torch.ones_like(denom))


def r2(y_true, y_pred):
    """Coefficient of determination (sklearn ``r2_score`` semantics)."""
    v, n, _ = _valid(y_true, y_pred)
    zero = _zero(y_true)
    t = torch.where(v, y_true, zero)
    tm = t.sum(dim=-1, keepdim=True) / n[..., None]
    ss_res = torch.where(v, (y_true - y_pred) ** 2, zero).sum(dim=-1)
    ss_tot = torch.where(v, (y_true - tm) ** 2, zero).sum(dim=-1)
    return 1.0 - ss_res / torch.where(ss_tot > 0, ss_tot, torch.ones_like(ss_tot))


def ks_stat(y_true, y_pred):
    """Two-sample Kolmogorov-Smirnov statistic per cell.

    ``sup |F_true - F_pred|`` between the two empirical CDFs along the last
    axis, evaluated at the ends of tie runs (``scipy.stats.ks_2samp``
    semantics) of one sort of the merged samples.  NaN and inf are skipped
    (sorted last as +inf pads, and no pad is a run end that counts);
    all-NaN rows return NaN.
    """
    v1 = torch.isfinite(y_true)
    v2 = torch.isfinite(y_pred)
    n1 = v1.sum(dim=-1)
    n2 = v2.sum(dim=-1)
    inf = torch.full((), float("inf"), dtype=y_true.dtype, device=y_true.device)
    vals = torch.cat([torch.where(v1, y_true, inf), torch.where(v2, y_pred, inf)], dim=-1)
    w1 = torch.cat([v1.to(vals.dtype), torch.zeros_like(y_pred)], dim=-1)
    w2 = torch.cat([torch.zeros_like(y_true), v2.to(vals.dtype)], dim=-1)
    sv, order = torch.sort(vals, dim=-1, stable=True)
    s1 = torch.gather(w1, -1, order)
    s2 = torch.gather(w2, -1, order)
    c1 = torch.cumsum(s1, dim=-1) / n1.clamp(min=1)[..., None]
    c2 = torch.cumsum(s2, dim=-1) / n2.clamp(min=1)[..., None]
    gap = (c1 - c2).abs()
    # the CDF gap only at tie-run ends over finite values (inf pads excluded)
    run_end = torch.cat(
        [sv[..., :-1] != sv[..., 1:], torch.ones_like(sv[..., :1], dtype=torch.bool)], dim=-1
    )
    d = torch.where(run_end & torch.isfinite(sv), gap, _zero(gap)).amax(dim=-1)
    return torch.where((n1 > 0) & (n2 > 0), d, torch.full_like(d, float("nan")))


def _nanquantile(a, q):
    """``jnp.nanquantile(a, q, axis=-1)`` (linear): NaN sorted last, the
    position ``q * (n - 1)`` among the ``n`` non-NaN values, the two values
    around it weighted by its fraction.  ``q`` a float or a 1-D sequence
    (a leading axis of the result).  ``torch.nanquantile`` refuses inputs
    of more than 2**24 elements."""
    qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    a = torch.sort(a, dim=-1).values  # NaN last
    counts = (~torch.isnan(a)).sum(dim=-1).to(a.dtype)  # (...)
    qq = qt.reshape(qt.shape + (1,) * counts.ndim) * (counts - 1)  # (nq?, ...)
    low = torch.floor(qq)
    high = torch.ceil(qq)
    high_w = qq - low
    low_w = 1.0 - high_w
    top = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top)).long()
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top)).long()
    src = a.expand(qt.shape + a.shape)
    low_v = torch.gather(src, -1, low[..., None])[..., 0]
    high_v = torch.gather(src, -1, high[..., None])[..., 0]
    return low_v * low_w + high_v * high_w


def quantile_bias(y_true, y_pred, q):
    """``quantile(y_pred, q) - quantile(y_true, q)`` per cell, NaN-skipping.

    ``q`` may be a scalar or a 1-D array of probabilities (prepended as a
    leading axis, numpy ``nanquantile`` convention).
    """
    return _nanquantile(y_pred, q) - _nanquantile(y_true, q)


def wet_day_freq_bias(y_true, y_pred, thresh=0.1):
    """Difference in exceedance frequency P(x > thresh) (pred - true): for
    precipitation at the 0.1 mm/day trace threshold, the wet-day-frequency
    bias."""
    v, n, _ = _valid(y_true, y_pred)
    zero = _zero(y_true)
    ft = torch.where(v, (y_true > thresh).to(y_true.dtype), zero).sum(dim=-1) / n
    fp = torch.where(v, (y_pred > thresh).to(y_pred.dtype), zero).sum(dim=-1) / n
    return fp - ft


def annual_cycle_rmse(y_true, y_pred, group_labels, n_groups: int = 12):
    """RMSE between per-group climatologies (e.g. monthly means).

    ``group_labels``: (T,) host int array in ``[0, n_groups)`` (month or DOY
    labels).  Group means are one mean-pooling matmul per series
    (NaN-aware); the result is the seasonal-cycle error per cell.
    """
    labels = np.asarray(group_labels)
    M = torch.as_tensor(
        (labels[:, None] == np.arange(n_groups)[None, :]).astype(np.float32), device=y_true.device
    )

    def gmean(x):
        v = torch.isfinite(x)
        Mx = M.to(x.dtype)
        xs = torch.where(v, x, _zero(x)) @ Mx
        c = v.to(x.dtype) @ Mx
        return xs / c.clamp(min=1.0), c

    mt, ct = gmean(y_true)
    mp, cp = gmean(y_pred)
    ok = (ct > 0) & (cp > 0)
    ng = ok.sum(dim=-1).clamp(min=1)
    se = torch.where(ok, (mp - mt) ** 2, _zero(mt))
    return torch.sqrt(se.sum(dim=-1) / ng)


def trend_bias(y_true, y_pred):
    """Difference of the linear-trend slopes (pred - true), per cell: masked
    OLS against ``arange(T)`` (``LinearTrendTransformer``'s model), in
    y-units per time step."""
    T = y_true.shape[-1]
    t = torch.arange(T, dtype=y_true.dtype, device=y_true.device)
    v1 = torch.isfinite(y_true)
    v2 = torch.isfinite(y_pred)
    s_t, _ = ols_1d(t, torch.where(v1, y_true, _zero(y_true)), v1.to(y_true.dtype))
    s_p, _ = ols_1d(t, torch.where(v2, y_pred, _zero(y_pred)), v2.to(y_pred.dtype))
    return s_p - s_t


def energy_distance(x, y):
    """Multivariate two-sample energy distance per cell.

    ``x``: (..., n, d) samples, ``y``: (..., m, d) samples; returns
    ``sqrt(2 E||X-Y|| - E||X-X'|| - E||Y-Y'||)`` with the V-statistic
    (all-pairs) means: zero iff the joint distributions match, MBCn's
    convergence diagnostic (Cannon 2018 §2.3).  The pairwise distances take
    the expanded ``x·x + y·y - 2 x·y`` form (one matmul); memory is O(n*m)
    per cell.  NaN anywhere in a sample row poisons that cell.
    """

    def _mean_pdist(a, b):
        an = (a * a).sum(dim=-1)  # (..., n)
        bn = (b * b).sum(dim=-1)  # (..., m)
        cross = a @ b.transpose(-1, -2)  # (..., n, m)
        d2 = an[..., :, None] + bn[..., None, :] - 2.0 * cross
        return torch.sqrt(d2.clamp(min=0.0)).mean(dim=(-2, -1))

    e2 = 2.0 * _mean_pdist(x, y) - _mean_pdist(x, x) - _mean_pdist(y, y)
    return torch.sqrt(e2.clamp(min=0.0))


def score_all(y_true, y_pred) -> dict:
    """The moment metrics at once."""
    return {
        "rmse": rmse(y_true, y_pred),
        "mae": mae(y_true, y_pred),
        "bias": bias(y_true, y_pred),
        "pearsonr": pearsonr(y_true, y_pred),
        "r2": r2(y_true, y_pred),
    }


def validation_report(y_true, preds: dict, *, quantile: float = 0.95, wet_thresh=None,
                      device="cuda"):
    """Moment and distribution validation table for a panel of corrections.

    ``y_true``: (..., T) observations; ``preds``: {name: (..., T)} candidate
    series.  Tensors stay where they are; an array ``y_true`` goes to
    ``device`` (the card unless the caller passes ``"cpu"``; float32 there)
    and an array prediction to ``y_true``'s device.  Returns a pandas
    DataFrame (rows = names) of cell-averaged metrics: bias, rmse, r²,
    two-sample KS, tail-quantile bias and, with ``wet_thresh``,
    wet-day-frequency bias.
    """
    import pandas as pd

    y_true = as_tensor(y_true, device, "validation_report")
    rows = []
    for name, p in preds.items():
        p = as_tensor(p, y_true.device, "validation_report")
        row = {
            "bias": float(torch.nanmean(bias(y_true, p))),
            "rmse": float(torch.nanmean(rmse(y_true, p))),
            "r2": float(torch.nanmean(r2(y_true, p))),
            "ks": float(torch.nanmean(ks_stat(y_true, p))),
            f"q{int(quantile * 100)}_bias": float(
                torch.nanmean(quantile_bias(y_true, p, quantile))
            ),
        }
        if wet_thresh is not None:
            row["wet_day_freq_bias"] = float(
                torch.nanmean(wet_day_freq_bias(y_true, p, wet_thresh))
            )
        rows.append(pd.Series(row, name=name))
    return pd.DataFrame(rows)
