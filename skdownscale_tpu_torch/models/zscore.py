"""Day-of-year z-score bias correction.

Port of ``skdownscale_tpu/models/zscore.py``, re-designing the reference's
``ZScoreRegressor`` (``pointwise_models/zscore.py``).  The reference
reshapes the series to a (year, day-of-year) xarray with December/January
bookends and takes a 31-day rolling ``construct`` mean/std over (year,
win_day) (``zscore.py:123-193``); here the (year, doy) matrix is a
host-built gather table and the windowed statistics are fixed-shape tensor
ops over a leading batch of cells.

Semantics kept from the JAX package:

* bookends: the last ``(window+1)//2`` day-columns prepended, the first
  ``window//2`` appended (``zscore.py:155-158``), then ``window//2 + 1``
  trimmed from both ends (``zscore.py:187-189``);
* fit stats pool over years and window, ``ddof=0`` (xarray defaults);
  predict rolling stats use pandas semantics, ``min_periods=window`` (NaN
  edges) and ``ddof=1`` (``zscore.py:267-269``);
* parameter expansion tiles the first ``min(n, 364)`` day-parameters
  positionally from the start of the series (``zscore.py:299-319``).

In float32 the fit centres each series on its nanmean before squaring
(the statistics are shift-equivariant, so only rounding changes): pooled
raw squares of ~283 K temperatures are ~8e4 against a day-of-year variance
of a few K^2, which float32 would cancel.  Float64 keeps the JAX package's
arithmetic.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..ops.rolling import _window_sum, rolling_mean_std
from .base import SingleCellEstimator, asarray_2d

__all__ = [
    "ZScoreRegressor",
    "ZScoreState",
    "zscore_fit",
    "zscore_predict",
    "build_year_doy_table",
    "expand_indices",
]


def build_year_doy_table(index) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (year, doy) gather table for a DatetimeIndex (or a
    ``TimeIndex``).

    Returns ``(idx, mask)`` of shape (n_years, n_days) where ``idx[y, d]``
    indexes the series and ``mask`` marks observed (year, doy) pairs.  The
    day axis is the union of observed day-of-year values (365 or 366),
    mirroring the xarray groupby/concat alignment (``zscore.py:150-158``).
    """
    years = np.asarray(index.year)
    doys = np.asarray(index.dayofyear)
    uyears = np.unique(years)
    ndays = int(doys.max())
    yrow = {int(y): i for i, y in enumerate(uyears)}
    idx = np.zeros((len(uyears), ndays), dtype=np.int32)
    mask = np.zeros((len(uyears), ndays), dtype=bool)
    for t, (yy, dd) in enumerate(zip(years, doys)):
        idx[yrow[int(yy)], dd - 1] = t
        mask[yrow[int(yy)], dd - 1] = True
    return idx, mask


class ZScoreState(NamedTuple):
    shift: torch.Tensor  # (..., D-1)
    scale: torch.Tensor
    x_mean: torch.Tensor
    x_std: torch.Tensor
    y_mean: torch.Tensor
    y_std: torch.Tensor


def _doy_window_stats(v, idx, mask, window: int):
    """Windowed mean/std (ddof=0) per day-of-year, pooled over years
    (``zscore.py:162-193``), for ``v`` (..., T).

    The year pooling and the day-of-year windowed sum are both linear, so
    the years are pooled first and the windowed sums run on (..., D + w)
    rows instead of (..., Y, D + w)."""
    if v.dtype == torch.float32:
        mu = torch.nanmean(v, dim=-1, keepdim=True)
    else:
        mu = v.new_zeros((*v.shape[:-1], 1))
    M = torch.where(mask, v[..., idx] - mu[..., None], 0.0)  # (..., Y, D)
    P1 = M.sum(dim=-2)
    P2 = (M * M).sum(dim=-2)
    del M
    PC = mask.sum(dim=-2).to(v.dtype)  # (D,)
    # bookends (zscore.py:155-158): isel(slice(-window//2, None)) takes
    # ceil(window/2) late-December columns, then the first window//2
    nlo = (window + 1) // 2
    nhi = window // 2

    def cat(a):
        return torch.cat([a[..., -nlo:], a, a[..., :nhi]], dim=-1)

    s1 = _window_sum(cat(P1), window, center=True)
    s2 = _window_sum(cat(P2), window, center=True)
    cc = _window_sum(cat(PC), window, center=True).clamp(min=1.0)
    mean = s1 / cc
    # one rounding for s2/cc - mean^2, as XLA's CPU contraction into an FMA
    # gives the JAX package: a window of one sample then keeps the same
    # rounding residue there instead of an exact 0
    std = torch.sqrt(torch.addcmul(s2 / cc, mean, mean, value=-1.0).clamp(min=0.0))
    trim = window // 2 + 1
    return mean[..., trim:-trim] + mu, std[..., trim:-trim]


def zscore_fit(x, y, idx, mask, *, window: int = 31) -> ZScoreState:
    """``ZScoreRegressor.fit`` core (``zscore.py:32-69``) for ``x``, ``y``
    (..., T) and the host table of :func:`build_year_doy_table`."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=x.device)
    mask = torch.as_tensor(np.asarray(mask), device=x.device)
    x_mean, x_std = _doy_window_stats(x, idx, mask, window)
    y_mean, y_std = _doy_window_stats(y, idx, mask, window)
    shift = y_mean - x_mean  # zscore.py:237
    scale = y_std / x_std  # zscore.py:238
    return ZScoreState(shift, scale, x_mean, x_std, y_mean, y_std)


def zscore_predict(state: ZScoreState, x, expand_inds, *, window: int = 31):
    """``ZScoreRegressor.predict`` core (``zscore.py:71-112``) for ``x``
    (..., T): the corrected series, the rolling mean and std of ``x``, and
    the corrected mean and std."""
    fut_mean, fut_std = rolling_mean_std(x, window, center=True, ddof=1)
    fut_zscore = (x - fut_mean) / fut_std
    # the JAX gather clamps an index past the fitted days to the last one
    # (a record whose last day of year is before Dec 31 reuses that day)
    inds = torch.as_tensor(np.asarray(expand_inds), dtype=torch.long, device=x.device)
    inds = inds.clamp(max=state.shift.shape[-1] - 1)
    mean_corr = fut_mean + state.shift[..., inds]
    std_corr = fut_std * state.scale[..., inds]
    return fut_zscore * std_corr + mean_corr, fut_mean, fut_std, mean_corr, std_corr


def expand_indices(n: int, len_avgyr: int = 364) -> np.ndarray:
    """``_expand_params`` index construction (``zscore.py:299-319``)."""
    la = min(n, len_avgyr)
    repeats = n // la
    remainder = n % la
    return np.concatenate([np.tile(np.arange(la), repeats), np.arange(remainder)]).astype(np.int32)


class ZScoreRegressor(SingleCellEstimator):
    """API of ``zscore.py:11-120``; fits and predicts on the single-cell
    device (``models/base.py``)."""

    _fit_attributes = ["shift_", "scale_"]
    _timestep = "MS"

    def __init__(self, window_width: int = 31):
        # validated at fit time, per sklearn convention (no errors in __init__)
        self.window_width = window_width

    def _index(self, X, n):
        import pandas as pd

        if hasattr(X, "index") and isinstance(X.index, pd.DatetimeIndex):
            return X.index
        warnings.warn("X does not have a pandas DateTimeIndex, making one up...")
        return pd.date_range(start="1950", periods=n, freq=self._timestep)

    def fit(self, X, y):
        if self.window_width <= 0:
            raise ValueError(f"window_width must be positive, got {self.window_width}")
        X, y = self._validate_data(X, y)
        Xa, ya = asarray_2d(X), asarray_2d(y)
        if Xa.shape[1] != 1:
            raise ValueError(f"Zscore only supports 1 feature, found {Xa.shape[1]}")
        idx, mask = build_year_doy_table(self._index(X, len(Xa)))
        state = zscore_fit(self._cell_tensor(Xa[:, 0]), self._cell_tensor(ya[:, 0]), idx, mask,
                           window=self.window_width)
        self._state = ZScoreState(*(t.cpu().numpy() for t in state))
        self.shift_ = self._state.shift
        self.scale_ = self._state.scale
        # day-of-year-indexed pandas Series, as the reference stores them
        # (``zscore.py:58-63``; its groupby('index.dayofyear') yields a
        # 1-based DOY index)
        import pandas as pd

        doy_index = pd.RangeIndex(1, len(self.shift_) + 1, name="dayofyear")
        st = self._state
        self.fit_stats_dict_ = {
            "X_mean": pd.Series(st.x_mean, index=doy_index),
            "X_std": pd.Series(st.x_std, index=doy_index),
            "y_mean": pd.Series(st.y_mean, index=doy_index),
            "y_std": pd.Series(st.y_std, index=doy_index),
        }
        return self

    def predict(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        Xa = asarray_2d(X)
        if Xa.shape[1] != 1:
            raise ValueError(f"X must have exactly 1 feature, got {Xa.shape[1]}")
        state = ZScoreState(*(self._cell_tensor(a) for a in self._state))
        outs = zscore_predict(state, self._cell_tensor(Xa[:, 0]), expand_indices(len(Xa)),
                              window=self.window_width)
        out, *stats = (t.cpu().numpy() for t in outs)
        stats = dict(zip(("meani", "stdi", "meanf", "stdf"), stats))
        if hasattr(X, "iloc"):
            import pandas as pd

            # time-indexed Series, as the reference stores them (``zscore.py:103-108``)
            self.predict_stats_dict_ = {k: pd.Series(v, index=X.index) for k, v in stats.items()}
            name = list(X.keys())[0] if hasattr(X, "keys") else 0
            return pd.DataFrame({name: out}, index=X.index)
        self.predict_stats_dict_ = stats
        return out.reshape(-1, 1)
