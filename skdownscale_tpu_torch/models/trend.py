"""Linear trend removal.

Port of ``skdownscale_tpu/models/trend.py``, re-designing
``LinearTrendTransformer`` (reference ``pointwise_models/trend.py:14-91``):
the reference fits one ``sklearn.LinearRegression`` per series against
``arange(n)``; here the fit is the centered closed form
(:func:`~..ops.regression.ols_1d`) over the last axis of a batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.regression import ols_1d, ols_predict_1d
from .base import SingleCellTransformer, asarray_2d

__all__ = [
    "TrendState",
    "trend_fit",
    "trend_fit_opts",
    "trend_line",
    "trend_transform",
    "trend_inverse",
    "LinearTrendTransformer",
]


class TrendState(NamedTuple):
    slope: torch.Tensor  # (...,) per series
    intercept: torch.Tensor


def _steps(x) -> torch.Tensor:
    return torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)


def trend_fit(x) -> TrendState:
    """Fit ``x ~ a + b*arange(n)`` over the last axis. ``x``: (..., n)."""
    slope, intercept = ols_1d(_steps(x), x)
    return TrendState(slope, intercept)


def trend_fit_opts(x, fit_intercept: bool = True, positive: bool = False) -> TrendState:
    """``trend_fit`` honoring sklearn ``LinearRegression(fit_intercept,
    positive)`` semantics (the reference forwards ``lr_kwargs`` to sklearn,
    ``trend.py:48-51``).  ``positive`` follows sklearn's NNLS on centered
    data, which for a single regressor clamps the OLS slope at zero and
    re-solves the intercept."""
    t = _steps(x)
    if fit_intercept:
        slope, intercept = ols_1d(t, x)
        if positive:
            clamped = slope < 0
            slope = torch.where(clamped, 0.0, slope)
            intercept = torch.where(clamped, x.mean(dim=-1), intercept)
    else:
        slope = (t * x).sum(dim=-1) / (t * t).sum()
        if positive:
            slope = slope.clamp(min=0.0)
        intercept = torch.zeros_like(slope)
    return TrendState(slope, intercept)


def trend_line(state: TrendState, n: int, dtype=None):
    """Evaluate the fitted trendline at ``arange(n)`` -> (..., n)."""
    dtype = dtype or state.slope.dtype
    t = torch.arange(n, dtype=dtype, device=state.slope.device)
    return ols_predict_1d(state.slope[..., None], state.intercept[..., None], t)


def trend_transform(state: TrendState, x):
    return x - trend_line(state, x.shape[-1], x.dtype)


def trend_inverse(state: TrendState, x):
    return x + trend_line(state, x.shape[-1], x.dtype)


class LinearTrendTransformer(SingleCellTransformer):
    """sklearn-compatible wrapper (API of ``trend.py:14-91``).

    Parameters
    ----------
    lr_kwargs : dict, optional
        Forwarded sklearn ``LinearRegression`` options (``trend.py:48-51``).
        ``fit_intercept`` and ``positive`` are honored; ``copy_X`` / ``n_jobs``
        are accepted no-ops; anything else raises.
    """

    _fit_attributes = ["lr_model_"]

    def __init__(self, lr_kwargs=None):
        self.lr_kwargs = lr_kwargs

    def _lr_options(self):
        kw = dict(self.lr_kwargs or {})
        fit_intercept = bool(kw.pop("fit_intercept", True))
        positive = bool(kw.pop("positive", False))
        kw.pop("copy_X", None)
        kw.pop("n_jobs", None)
        if kw:
            raise ValueError(f"unsupported lr_kwargs: {sorted(kw)}")
        return fit_intercept, positive

    def fit(self, X, y=None):
        X = self._validate_data(X)
        vals = asarray_2d(X)  # (n, k)
        fit_intercept, positive = self._lr_options()
        state = trend_fit_opts(self._cell_tensor(vals.T), fit_intercept, positive)
        self._state = TrendState(*(t.cpu().numpy() for t in state))
        self.lr_model_ = _FittedLinearModel(
            coef_=self._state.slope.reshape(-1, 1), intercept_=self._state.intercept
        )
        self._n_fit = vals.shape[0]
        return self

    def transform(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        return X - self.trendline(X)

    def inverse_transform(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        return X + self.trendline(X)

    def trendline(self, X):
        """Trendline evaluated over ``arange(len(X))`` (``trend.py:80-83``)."""
        self._check_is_fitted()
        n = len(asarray_2d(X))
        state = TrendState(*(self._cell_tensor(a) for a in self._state))
        return trend_line(state, n).cpu().numpy().T  # (n, k)


class _FittedLinearModel:
    """Duck-type of the fitted ``sklearn.LinearRegression`` the reference
    exposes as ``lr_model_`` (used by ``QuantileMapper`` at
    ``quantile.py:145`` for the intercept-bias reset)."""

    def __init__(self, coef_, intercept_):
        self.coef_ = coef_
        self.intercept_ = intercept_

    def predict(self, t):
        t = np.asarray(t).reshape(-1)
        return t[:, None] * self.coef_.T + self.intercept_[None, :]
