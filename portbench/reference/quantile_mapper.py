"""Plain reference of scikit-downscale's ``QuantileMapper(detrend=True)``.

Written from the published algorithm (scikit-downscale,
``pointwise_models/quantile.py``: ``QuantileMapper``, ``CunnaneTransformer``,
``plotting_positions``; ``pointwise_models/trend.py``:
``LinearTrendTransformer``), batched over rows in plain PyTorch.  It imports
nothing of the program under test and takes nothing it made: it works the
trends, sorts, ranks and maps out again from the benchmark's own inputs.

``fit`` rows ``(C, n_fit)`` and ``x`` rows ``(C, n)``; one row a grid cell.
For each row:

1. fit: ``LinearTrendTransformer().fit(fit)`` (least squares on
   ``arange(n_fit)``), the detrended record, its Cunnane CDF (sorted
   values, plotting positions ``(i - a) / (n + 1 - a - b)``);
2. transform: the trend of ``x`` fitted and removed, each value's plotting
   position in its own record (``np.interp(x, sort(x), pp)``: tied values
   take the last tied slot's), mapped through the fit CDF by
   ``np.interp`` with ordinary-least-squares tails over ``n_endpoints``
   end knots (``extrapolate="both"``), the trend of ``x`` added back and the
   baseline reset by the difference of the two intercepts.

``dtype`` is the precision the reference computes in: float64 to judge,
a lower one (bfloat16) as the control.
"""

from __future__ import annotations

import torch

ALPHA = BETA = 0.4  # CunnaneTransformer's defaults
N_ENDPOINTS = 10


def trend(x: torch.Tensor):
    """(slope, intercept) of ``x ~ a + b * t``, ``t = arange(n)``, per row."""
    n = x.shape[-1]
    t = torch.arange(n, dtype=x.dtype, device=x.device)
    tm = (n - 1) / 2.0
    dt = t - tm
    xm = x.mean(dim=-1, keepdim=True)
    slope = (dt * (x - xm)).sum(dim=-1) / (dt * dt).sum()
    intercept = xm[..., 0] - slope * tm
    return slope, intercept


def detrend(x: torch.Tensor, slope, intercept):
    t = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)
    return x - (intercept[..., None] + slope[..., None] * t)


def plotting_positions(n: int, dtype, device, alpha=ALPHA, beta=BETA):
    i = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    return ((i - alpha) / (n + 1.0 - alpha - beta)).to(dtype)


def ols(xk: torch.Tensor, yk: torch.Tensor):
    """(slope, intercept) of least squares ``yk ~ a + b * xk`` per row; a
    row whose ``xk`` does not vary gets slope 0 (the minimum-norm answer)."""
    xk, yk = torch.broadcast_tensors(xk, yk)
    dx = xk - xk.mean(dim=-1, keepdim=True)
    den = (dx * dx).sum(dim=-1)
    num = (dx * (yk - yk.mean(dim=-1, keepdim=True))).sum(dim=-1)
    slope = torch.where(den != 0, num / torch.where(den != 0, den, torch.ones_like(den)), torch.zeros_like(num))
    return slope, yk.mean(dim=-1) - slope * xk.mean(dim=-1)


def interp(q: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """``np.interp(q, xp, fp)`` row by row: ``xp`` (L,) shared or (rows, L),
    ``fp`` (rows, L), ``q`` (rows, Q); clamped ends, a query on tied knots
    takes the last of them.  The line is evaluated from the nearer of the
    two knots: next to a synthetic knot at -+1e20 (the extrapolated CDFs of
    MBCn's margins) the form ``f0 + w * (f1 - f0)`` from the far knot
    cancels to nothing, while the exact value lies within a step of the
    near knot's."""
    rows, L = fp.shape
    xr = xp.expand(rows, L).contiguous()
    j = torch.searchsorted(xr, q.contiguous(), right=True) - 1
    jl = j.clamp(0, L - 2)
    x0, x1 = xr.gather(-1, jl), xr.gather(-1, jl + 1)
    f0, f1 = fp.gather(-1, jl), fp.gather(-1, jl + 1)
    dx = x1 - x0
    safe = torch.where(dx > 0, dx, torch.ones_like(dx))
    zero = torch.zeros_like(dx)
    w0 = torch.where(dx > 0, (q - x0) / safe, zero)
    w1 = torch.where(dx > 0, (q - x1) / safe, zero)
    df = f1 - f0
    out = torch.where(q - x0 > x1 - q, f1 + w1 * df, f0 + w0 * df)
    out = torch.where(q >= xr[:, -1:], fp[:, -1:].expand_as(out), out)
    return torch.where(q < xr[:, :1], fp[:, :1].expand_as(out), out)


def self_plotting_positions(x: torch.Tensor):
    """Each value's plotting position in its own row: ``np.interp(x,
    sort(x), pp)``, ties at the last tied slot."""
    s = torch.sort(x, dim=-1).values
    last = torch.searchsorted(s, x.contiguous(), right=True) - 1
    pp = plotting_positions(x.shape[-1], x.dtype, x.device)
    return pp[last]


def inverse_cdf(q: torch.Tensor, fit_vals: torch.Tensor, n_endpoints=N_ENDPOINTS):
    """``CunnaneTransformer.inverse_transform`` with ``extrapolate="both"``:
    ``q`` through the fit CDF (plotting positions to sorted values), a
    ``q`` below the first or above the last knot by least squares over the
    ``n_endpoints`` end knots."""
    pp = plotting_positions(fit_vals.shape[-1], fit_vals.dtype, fit_vals.device)
    out = interp(q, pp, fit_vals)
    ne = min(n_endpoints, pp.shape[0])
    lo_s, lo_i = ols(pp[:ne], fit_vals[:, :ne])
    hi_s, hi_i = ols(pp[-ne:], fit_vals[:, -ne:])
    out = torch.where(q < pp[0], lo_i[:, None] + lo_s[:, None] * q, out)
    return torch.where(q > pp[-1], hi_i[:, None] + hi_s[:, None] * q, out)


def qm_detrend(fit: torch.Tensor, x: torch.Tensor, dtype=torch.float64):
    """``QuantileMapper(detrend=True).fit(fit).transform(x)`` per row,
    computed in ``dtype``; returns ``(C, n)`` in ``dtype``."""
    fit, x = fit.to(dtype), x.to(dtype)
    f_slope, f_int = trend(fit)
    fit_vals = torch.sort(detrend(fit, f_slope, f_int), dim=-1).values
    x_slope, x_int = trend(x)
    q = self_plotting_positions(detrend(x, x_slope, x_int))
    mapped = inverse_cdf(q, fit_vals)
    t = torch.arange(x.shape[-1], dtype=dtype, device=x.device)
    mapped = mapped + (x_int[:, None] + x_slope[:, None] * t)
    return mapped - (x_int - f_int)[:, None]
