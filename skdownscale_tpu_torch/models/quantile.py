"""Quantile-mapping model family.

Port of ``skdownscale_tpu/models/quantile.py``, re-designing the reference's
quantile machinery (``pointwise_models/quantile.py``) as batched functional
cores over ``(..., n)`` tensors (leading dims are grid cells) plus thin
sklearn-compatible wrappers with the reference's public API:

* :class:`CunnaneTransformer`  (``quantile.py:398-553``)
* :class:`QuantileMapper`      (``quantile.py:46-157``)
* :class:`QuantileMappingReressor`  [sic: the typo is public API]
  (``quantile.py:160-395``)
* :class:`EquidistantCdfMatcher`    (``quantile.py:556-636``)
* :class:`TrendAwareQuantileMappingRegressor` (``quantile.py:639-716``)

Table interpolation runs the kernel K6 (:mod:`..kernels.interp`, through
:func:`~..ops.interp.interp_rows`); ``QuantileMapper.transform`` runs the
rank map K2 (:mod:`..kernels.rank_map`) with one segment per row.

Known reference quirks handled deliberately, as in the JAX package:

* ``QuantileMappingReressor.predict`` re-extrapolates out-of-range plotting
  positions with a linear model fit in the (pp -> vals) direction but
  *evaluated on vals* (``quantile.py:256-264``); replicated verbatim for
  output parity.
* ``EquidistantCdfMatcher`` with ``max_ratio`` uses ``np.min(ratio, max_ratio)``
  (``quantile.py:624``), which crashes in numpy; the evident intent,
  ``np.minimum`` (elementwise clip), is implemented.
* ``CunnaneTransformer.transform`` tail extrapolation calls ``.values`` on an
  ndarray (``quantile.py:497``) and would crash; the evident intent
  (extrapolate out-of-range queries by OLS over the end knots) is
  implemented.
"""

from __future__ import annotations

import copy
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cdf import SYNTHETIC_MAX, SYNTHETIC_MIN, Cdf, calc_extrapolated_cdf, plotting_positions
from ..ops.interp import interp_rows
from ..ops.regression import ols_1d
from .base import SingleCellEstimator, SingleCellTransformer, asarray_2d
from .grouped import _rank_bracket_row, apply_ranked_rows
from .trend import LinearTrendTransformer, TrendState, trend_fit, trend_line

__all__ = [
    "CunnaneTransformer",
    "QuantileMapper",
    "QuantileMappingReressor",
    "EquidistantCdfMatcher",
    "TrendAwareQuantileMappingRegressor",
    # functional cores
    "QmState",
    "QmrState",
    "cunnane_fit",
    "cunnane_transform",
    "cunnane_inverse",
    "qm_fit",
    "qm_transform",
    "qmr_fit",
    "qmr_predict",
    "edcdfm_predict",
]

_VALID_EXTRAPOLATE = (None, "1to1", "min", "max", "both")
_INF = float("inf")


def _check_extrapolate(extrapolate):
    if extrapolate not in _VALID_EXTRAPOLATE:
        raise ValueError(f"unknown value for extrapolate: {extrapolate}")


# ======================================================================
# functional cores (batch-native: tensors are (..., n), leading dims = cells)
# ======================================================================


def cunnane_fit(x, alpha: float = 0.4, beta: float = 0.4) -> Cdf:
    """``CunnaneTransformer.fit`` (``quantile.py:462``): plotting positions
    (an expand of one vector) + sorted values.  ``x``: (..., n)."""
    pp = plotting_positions(x.shape[-1], alpha, beta, dtype=x.dtype, device=x.device)
    return Cdf(pp.expand(x.shape), torch.sort(x, dim=-1, stable=True).values)


def _tail_ols_fill(res, query, table_x, table_y, n_endpoints: int):
    """Replace +-inf entries of ``res`` with OLS tail extrapolations fit on
    the first/last ``n_endpoints`` knots of (table_x -> table_y), evaluated
    at ``query`` (``quantile.py:490-503`` / ``532-545``)."""
    lo_s, lo_i = ols_1d(table_x[..., :n_endpoints], table_y[..., :n_endpoints])
    hi_s, hi_i = ols_1d(table_x[..., -n_endpoints:], table_y[..., -n_endpoints:])
    res = torch.where(torch.isneginf(res), lo_i[..., None] + lo_s[..., None] * query, res)
    res = torch.where(torch.isposinf(res), hi_i[..., None] + hi_s[..., None] * query, res)
    return res


def _tails(extrapolate):
    return extrapolate in ("min", "both"), extrapolate in ("max", "both")


def cunnane_transform(cdf: Cdf, x, extrapolate="both", n_endpoints: int = 10):
    """values -> plotting positions (``quantile.py:465-503``)."""
    left, right = _tails(extrapolate)
    pps = interp_rows(cdf.vals, cdf.pp, x)
    if left:
        pps = torch.where(x < cdf.vals[..., 0:1], -_INF, pps)
    if right:
        pps = torch.where(x > cdf.vals[..., -1:], _INF, pps)
    if left or right:
        pps = _tail_ols_fill(pps, x, cdf.vals, cdf.pp, n_endpoints)
    return pps


def cunnane_inverse(cdf: Cdf, q, extrapolate="both", n_endpoints: int = 10):
    """plotting positions -> values (``quantile.py:523-545``)."""
    left, right = _tails(extrapolate)
    vals = interp_rows(cdf.pp, cdf.vals, q)
    if left:
        vals = torch.where(q < cdf.pp[..., 0:1], -_INF, vals)
    if right:
        vals = torch.where(q > cdf.pp[..., -1:], _INF, vals)
    if left or right:
        vals = _tail_ols_fill(vals, q, cdf.pp, cdf.vals, n_endpoints)
    return vals


class QmState(NamedTuple):
    """Fitted state of :class:`QuantileMapper`."""

    cdf_pp: torch.Tensor  # (..., n_fit)
    cdf_vals: torch.Tensor  # (..., n_fit)
    trend_slope: torch.Tensor  # (...,): zeros when detrend=False
    trend_intercept: torch.Tensor  # (...,)


def qm_fit(x, *, detrend: bool = False, alpha: float = 0.4, beta: float = 0.4) -> QmState:
    """``QuantileMapper.fit`` (``quantile.py:81-107``) on (..., n) series."""
    if detrend:
        tr = trend_fit(x)
        x_to_cdf = x - trend_line(tr, x.shape[-1], x.dtype)
    else:
        zeros = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        tr = TrendState(zeros, zeros.clone())
        x_to_cdf = x
    cdf = cunnane_fit(x_to_cdf, alpha, beta)
    return QmState(cdf.pp, cdf.vals, tr.slope, tr.intercept)


def _cunnane_grid(n: int, alpha: float, beta: float) -> np.ndarray:
    """Host (numpy float64) Cunnane grid, the formula of
    :func:`~..ops.cdf.plotting_positions` (``quantile.py:23-43``)."""
    return (np.arange(1, n + 1, dtype=np.float64) - alpha) / (n + 1.0 - alpha - beta)


@functools.lru_cache(maxsize=64)
def _qm_tables(n: int, n_fit: int, alpha: float, beta: float, device, dtype):
    """Device copies of the host rank-bracket plan of :func:`qm_transform`:
    rank ``r`` of a length-``n`` series maps through the length-``n_fit``
    fit grid by the takes ``lo``/``hi`` and the weights ``w0``/``w1``."""
    qpp = _cunnane_grid(n, alpha, beta)
    fpp = _cunnane_grid(n_fit, alpha, beta)
    lo, hi, w0, w1, right, below, above = _rank_bracket_row(fpp, qpp)

    def f(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    def i(a):
        return torch.as_tensor(a, dtype=torch.long).to(device)

    return {
        "lo": i(lo), "hi": i(hi), "w0": f(w0), "w1": f(w1),
        "right": torch.as_tensor(right).to(device),
        "below": torch.as_tensor(below).to(device), "any_below": bool(below.any()),
        "above": torch.as_tensor(above).to(device), "any_above": bool(above.any()),
        "qpp": f(qpp), "fpp": fpp,
    }


def qm_transform(
    state: QmState,
    x,
    *,
    detrend: bool = False,
    alpha: float = 0.4,
    beta: float = 0.4,
    extrapolate="both",
    n_endpoints: int = 10,
):
    """``QuantileMapper.transform`` (``quantile.py:109-147``): fresh CDF of the
    new series -> plotting positions -> inverse through the stored fit CDF,
    with optional detrend/retrend and intercept-bias reset.

    Fit-transform on self assigns rank plotting positions
    (``quantile.py:138``), and both pp grids are pure functions of (rank,
    length, alpha, beta), so each rank's bracket in the fit grid and its
    lerp weights are host tables; per element the map is two takes and one
    fma, placed in element order by the rank map K2 with one segment per
    row.  ``alpha``/``beta`` must be the pair the state was fit with."""
    if detrend:
        tr_new = trend_fit(x)
        x_to_cdf = x - trend_line(tr_new, x.shape[-1], x.dtype)
    else:
        x_to_cdf = x
    n = x.shape[-1]
    n_fit = state.cdf_vals.shape[-1]
    tb = _qm_tables(n, n_fit, alpha, beta, x.device, x.dtype)

    vals = state.cdf_vals  # (..., n_fit)
    f0 = vals.index_select(-1, tb["lo"])
    f1 = vals.index_select(-1, tb["hi"])
    df = f1 - f0
    res = torch.where(tb["right"], f1 + tb["w1"] * df, f0 + tb["w0"] * df)
    # tail extrapolation (quantile.py:532-545): OLS over the first/last
    # n_endpoints (pp -> vals) knots, evaluated at the out-of-range rank pps
    ne = min(n_endpoints, n_fit)
    fpp = tb["fpp"]
    if extrapolate in ("min", "both") and tb["any_below"]:
        lo_s, lo_i = ols_1d(torch.as_tensor(fpp[:ne], dtype=x.dtype).to(x.device), vals[..., :ne])
        res = torch.where(tb["below"], lo_i[..., None] + lo_s[..., None] * tb["qpp"], res)
    if extrapolate in ("max", "both") and tb["any_above"]:
        hi_s, hi_i = ols_1d(torch.as_tensor(fpp[-ne:], dtype=x.dtype).to(x.device), vals[..., -ne:])
        res = torch.where(tb["above"], hi_i[..., None] + hi_s[..., None] * tb["qpp"], res)

    lead = x.shape[:-1]
    rows_q = x_to_cdf.reshape(-1, n)
    res_rows = torch.broadcast_to(res, (*lead, n)).reshape(-1, n)
    x_qmapped = apply_ranked_rows(res_rows, rows_q).reshape(*lead, n)

    if detrend:
        x_qmapped = x_qmapped + trend_line(tr_new, n, x.dtype)
        # reset the baseline (quantile.py:145)
        x_qmapped = x_qmapped - (tr_new.intercept[..., None] - state.trend_intercept[..., None])
    return x_qmapped


class QmrState(NamedTuple):
    """Fitted state of :class:`QuantileMappingReressor`: two extrapolated CDFs."""

    x_pp: torch.Tensor  # (..., nx+2)
    x_vals: torch.Tensor
    y_pp: torch.Tensor  # (..., ny+2)
    y_vals: torch.Tensor


def qmr_fit(x, y, *, extrapolate=None, n_endpoints: int = 10) -> QmrState:
    """``QuantileMappingReressor.fit`` (``quantile.py:195-219``)."""
    xc = calc_extrapolated_cdf(x, sort=True, extrapolate=extrapolate, n_endpoints=n_endpoints)
    yc = calc_extrapolated_cdf(y, sort=True, extrapolate=extrapolate, n_endpoints=n_endpoints)
    return QmrState(xc.pp, xc.vals, yc.pp, yc.vals)


def _take_window(a, start, ne: int):
    """``a[..., start : start+ne]`` with a per-row ``start`` (clip semantics)."""
    idx = start[..., None] + torch.arange(ne, device=a.device)
    idx = idx.clamp(0, a.shape[-1] - 1)
    return torch.gather(a, -1, idx)


def _reextrapolate_pp(pp, vals, n_endpoints: int):
    """The reference's out-of-range pp handling (``quantile.py:253-264``).

    ``pp`` is non-decreasing along the last axis with a possible ``-inf``
    prefix and ``+inf`` suffix.  For each tail, an OLS model is fit on the
    ``n_endpoints`` knots adjacent to the run, in the (pp -> vals)
    direction, and then *evaluated on vals* (the reference's inverted usage,
    replicated for parity)."""
    m = pp.shape[-1]
    neg = torch.isneginf(pp)
    pos = torch.isposinf(pp)
    c_lo = neg.sum(dim=-1)
    c_hi = pos.sum(dim=-1)

    ne = min(n_endpoints, m)
    s_lo, i_lo = ols_1d(_take_window(pp, c_lo, ne), _take_window(vals, c_lo, ne))
    pred_lo = i_lo[..., None] + s_lo[..., None] * vals

    start_hi = m - c_hi - ne
    s_hi, i_hi = ols_1d(_take_window(pp, start_hi, ne), _take_window(vals, start_hi, ne))
    pred_hi = i_hi[..., None] + s_hi[..., None] * vals

    pp = torch.where(neg, pred_lo, pp)
    pp = torch.where(pos, pred_hi, pp)
    return pp


def _interp_scalar(xp, fp, q):
    """Per-row scalar interp: q (...,) against (..., L) tables."""
    return interp_rows(xp, fp, q[..., None])[..., 0]


def _extrapolate_1to1(state: QmrState, x, y_hat):
    """``QuantileMappingReressor._extrapolate_1to1`` (``quantile.py:277-310``),
    including the asymmetric under-min ``X_fit_len > y_fit_len`` branch as
    written at ``quantile.py:305``."""
    X_fit_len = state.x_vals.shape[-1]
    y_fit_len = state.y_vals.shape[-1]
    X_fit_min, X_fit_max = state.x_vals[..., 0:1], state.x_vals[..., -1:]
    y_fit_min, y_fit_max = state.y_vals[..., 0:1], state.y_vals[..., -1:]

    if X_fit_len == y_fit_len:
        hi = y_fit_max + (x - X_fit_max)
    elif X_fit_len > y_fit_len:
        X_fit_at_y_fit_max = _interp_scalar(state.x_pp, state.x_vals, state.y_pp[..., -1])
        hi = y_fit_max + (x - X_fit_at_y_fit_max[..., None])
    else:
        y_fit_at_X_fit_max = _interp_scalar(state.y_pp, state.y_vals, state.x_pp[..., -1])
        hi = y_fit_at_X_fit_max[..., None] + (x - X_fit_max)
    y_hat = torch.where(x > X_fit_max, hi, y_hat)

    if X_fit_len == y_fit_len:
        lo = y_fit_min + (x - X_fit_min)
    elif X_fit_len > y_fit_len:
        X_fit_at_y_fit_min = _interp_scalar(state.x_pp, state.x_vals, state.y_pp[..., 0])
        lo = X_fit_min + (x - X_fit_at_y_fit_min[..., None])
    else:
        y_fit_at_X_fit_min = _interp_scalar(state.y_pp, state.y_vals, state.x_pp[..., 0])
        lo = y_fit_at_X_fit_min[..., None] + (x - X_fit_min)
    y_hat = torch.where(x < X_fit_min, lo, y_hat)
    return y_hat


def _host_extrap_pp(n: int, extrapolate, alpha: float = 0.4, beta: float = 0.4) -> np.ndarray:
    """Host (numpy float64) copy of the extrapolated plotting-position grid
    that :func:`~..ops.cdf.calc_extrapolated_cdf` builds on the device:
    Cunnane core bracketed by the synthetic endpoints
    (``quantile.py:312-387``), a pure function of (n, extrapolate)."""
    core = _cunnane_grid(n, alpha, beta)
    first = SYNTHETIC_MIN if extrapolate in ("min", "both") else core[0]
    last = SYNTHETIC_MAX if extrapolate in ("max", "both") else core[-1]
    return np.concatenate([[first], core, [last]])


@functools.lru_cache(maxsize=None)
def _pp_bracket_tables(nq: int, nfit: int, extrapolate):
    """Host rank-bracket plan mapping the (nq+2,) extrapolated query pp grid
    through the (nfit+2,) extrapolated fit pp grid: each query rank's
    bracketing knots, lerp weights and nearer-knot anchor are
    data-independent, so the merge interp of ``quantile.py:615/620`` is two
    takes and one fma."""
    qpp = _host_extrap_pp(nq, extrapolate)
    fpp = _host_extrap_pp(nfit, extrapolate)
    lo, hi, w0, w1, right, _below, _above = _rank_bracket_row(fpp, qpp)
    return lo.astype(np.int32), hi.astype(np.int32), w0, w1, right


def _bracket_interp(vals, tabs, dtype):
    """Apply a host bracket plan to a (..., nfit+2) value table -> (..., nq+2).
    Out-of-range query pps were clamped to the end knots by the plan
    (np.interp clamp semantics, matching :func:`interp_rows`)."""
    lo, hi, w0, w1, right = tabs
    dev = vals.device
    f0 = vals.index_select(-1, torch.as_tensor(lo, dtype=torch.long).to(dev))
    f1 = vals.index_select(-1, torch.as_tensor(hi, dtype=torch.long).to(dev))
    df = f1 - f0
    w0 = torch.as_tensor(w0, dtype=dtype).to(dev)
    w1 = torch.as_tensor(w1, dtype=dtype).to(dev)
    return torch.where(torch.as_tensor(right).to(dev), f1 + w1 * df, f0 + w0 * df)


def _sort_with_positions(x):
    """Stable sort -> (sorted x, original positions)."""
    out = torch.sort(x, dim=-1, stable=True)
    return out.values, out.indices


def _unsort(sorted_vals, sort_inds):
    """Restore element order: scatter by the sort's positions (the inverse
    permutation)."""
    out = torch.empty_like(sorted_vals)
    return out.scatter_(-1, sort_inds, sorted_vals)


def qmr_predict(state: QmrState, x, *, extrapolate=None, n_endpoints: int = 10):
    """``QuantileMappingReressor.predict`` (``quantile.py:221-275``): two
    table interps (K6), the first against per-cell knots with the shared
    plotting positions as values, the second the reverse."""
    xs, sort_inds = _sort_with_positions(x)
    tc = calc_extrapolated_cdf(xs, sort=False, extrapolate=extrapolate, n_endpoints=n_endpoints)

    pp = interp_rows(state.x_vals, state.x_pp, tc.vals)
    if extrapolate in ("min", "both"):
        pp = torch.where(tc.vals < state.x_vals[..., 0:1], -_INF, pp)
    if extrapolate in ("max", "both"):
        pp = torch.where(tc.vals > state.x_vals[..., -1:], _INF, pp)
    if extrapolate in ("min", "max", "both"):
        pp = _reextrapolate_pp(pp, tc.vals, n_endpoints)

    yhat_sorted = interp_rows(state.y_pp, state.y_vals, pp)
    y_hat = _unsort(yhat_sorted[..., 1:-1], sort_inds)
    if extrapolate == "1to1":
        y_hat = _extrapolate_1to1(state, x, y_hat)
    return y_hat


def edcdfm_predict(
    state: QmrState,
    x,
    *,
    kind: str = "difference",
    extrapolate=None,
    n_endpoints: int = 10,
    max_ratio: float | None = None,
):
    """``EquidistantCdfMatcher.predict`` (``quantile.py:594-636``): preserve
    the per-quantile difference (or ratio) between test X and train X."""
    xs, sort_inds = _sort_with_positions(x)
    tc = calc_extrapolated_cdf(xs, sort=False, extrapolate=extrapolate, n_endpoints=n_endpoints)
    if (
        state.x_pp.shape == state.y_pp.shape
        and state.x_pp.shape[-1] == tc.pp.shape[-1]
        and state.x_pp.dtype == tc.pp.dtype
    ):
        # equal fit/predict lengths: the plotting-position grids are equal
        # by construction, and np.interp at exact knots returns the knot
        # values, so both interps of quantile.py:615-620 are the identity
        X_train_vals = torch.broadcast_to(state.x_vals, tc.vals.shape)
        y_train_vals = torch.broadcast_to(state.y_vals, tc.vals.shape)
    else:
        # unequal lengths: every pp grid is a pure function of (length,
        # extrapolate), so both merge interps are host rank-bracket takes
        nq = x.shape[-1]
        tabs_x = _pp_bracket_tables(nq, state.x_pp.shape[-1] - 2, extrapolate)
        X_train_vals = _bracket_interp(state.x_vals, tabs_x, x.dtype)
        if state.y_pp.shape[-1] == state.x_pp.shape[-1]:
            tabs_y = tabs_x
        else:
            tabs_y = _pp_bracket_tables(nq, state.y_pp.shape[-1] - 2, extrapolate)
        y_train_vals = _bracket_interp(state.y_vals, tabs_y, x.dtype)
    if kind == "difference":
        sorted_y_hat = y_train_vals + (tc.vals - X_train_vals)
    else:  # 'ratio'
        ratio = tc.vals / X_train_vals
        if max_ratio is not None:
            ratio = ratio.clamp(max=max_ratio)  # intent of quantile.py:624
        sorted_y_hat = y_train_vals * ratio
    y_hat = _unsort(sorted_y_hat[..., 1:-1], sort_inds)
    if extrapolate == "1to1":
        y_hat = _extrapolate_1to1(state, x, y_hat)
    return y_hat


# ======================================================================
# sklearn-compatible wrappers (single cell, on ``single_cell_device``)
# ======================================================================


class CunnaneTransformer(SingleCellTransformer):
    """API of ``quantile.py:398-553``; single feature only."""

    _fit_attributes = ["cdf_"]

    def __init__(self, *, alpha=0.4, beta=0.4, extrapolate="both", n_endpoints=10):
        self.alpha = alpha
        self.beta = beta
        self.extrapolate = extrapolate
        self.n_endpoints = n_endpoints

    def fit(self, X, y=None):
        _check_extrapolate(self.extrapolate)
        arr = asarray_2d(X)
        if arr.shape[1] > 1:
            raise ValueError("CunnaneTransformer.fit() only supports a single feature")
        cdf = cunnane_fit(self._cell_tensor(arr[:, 0]), alpha=self.alpha, beta=self.beta)
        self.cdf_ = Cdf(cdf.pp.cpu().numpy(), cdf.vals.cpu().numpy())
        return self

    def _cdf_dev(self):
        return Cdf(self._cell_tensor(self.cdf_.pp), self._cell_tensor(self.cdf_.vals))

    def transform(self, X):
        self._check_is_fitted()
        arr = asarray_2d(X)
        if arr.shape[1] > 1:
            raise ValueError("CunnaneTransformer.transform() only supports a single feature")
        pps = cunnane_transform(
            self._cdf_dev(), self._cell_tensor(arr[:, 0]), self.extrapolate, self.n_endpoints
        )
        return pps.cpu().numpy().reshape(-1, 1)

    def inverse_transform(self, X):
        self._check_is_fitted()
        arr = asarray_2d(X)
        vals = cunnane_inverse(
            self._cdf_dev(), self._cell_tensor(arr[:, 0]), self.extrapolate, self.n_endpoints
        )
        return vals.cpu().numpy().reshape(-1, 1)


class QuantileMapper(SingleCellTransformer):
    """API of ``quantile.py:46-157``.

    Parameters
    ----------
    detrend : bool
        Detrend before mapping, retrend after (with intercept-bias reset).
    lt_kwargs, qt_kwargs : dict, optional
        Passed to the trend transformer / CunnaneTransformer.
    """

    _fit_attributes = ["x_cdf_fit_"]

    def __init__(self, detrend=False, lt_kwargs=None, qt_kwargs=None):
        self.detrend = detrend
        self.lt_kwargs = lt_kwargs
        self.qt_kwargs = qt_kwargs

    def _qt_params(self):
        kw = dict(self.qt_kwargs or {})
        return {
            "alpha": kw.get("alpha", 0.4),
            "beta": kw.get("beta", 0.4),
            "extrapolate": kw.get("extrapolate", "both"),
            "n_endpoints": kw.get("n_endpoints", 10),
        }

    def fit(self, X, y=None):
        X = self._validate_data(X, max_features=1)
        arr = asarray_2d(X)
        p = self._qt_params()
        state = qm_fit(
            self._cell_tensor(arr[:, 0]), detrend=bool(self.detrend), alpha=p["alpha"], beta=p["beta"]
        )
        self._state = QmState(*(t.cpu().numpy() for t in state))
        # expose a fitted CunnaneTransformer as the reference does (quantile.py:105)
        qt = CunnaneTransformer(
            alpha=p["alpha"], beta=p["beta"], extrapolate=p["extrapolate"], n_endpoints=p["n_endpoints"]
        )
        qt.cdf_ = Cdf(self._state.cdf_pp, self._state.cdf_vals)
        self.x_cdf_fit_ = qt
        return self

    def transform(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        arr = asarray_2d(X)
        p = self._qt_params()
        out = qm_transform(
            QmState(*(self._cell_tensor(a) for a in self._state)),
            self._cell_tensor(arr[:, 0]),
            detrend=bool(self.detrend),
            alpha=p["alpha"],
            beta=p["beta"],
            extrapolate=p["extrapolate"],
            n_endpoints=p["n_endpoints"],
        )
        return out.cpu().numpy().reshape(-1, 1)


class QuantileMappingReressor(SingleCellEstimator):
    """API of ``quantile.py:160-395`` (class-name typo is public API,
    ``__init__.py:11``)."""

    _fit_attributes = ["_X_cdf", "_y_cdf"]
    _allow_length_mismatch = True

    def __init__(self, extrapolate=None, n_endpoints=10):
        # unlike the reference (quantile.py:188-189) params are validated at
        # fit time, per sklearn convention (no errors in __init__/set_params)
        self.extrapolate = extrapolate
        self.n_endpoints = n_endpoints

    def _min_samples_check(self, arr, name):
        if self.n_endpoints < 2:
            raise ValueError("Invalid number of n_endpoints, must be >= 2")
        need = 2 * self.n_endpoints + 1
        if arr.shape[0] < need:
            raise ValueError(
                f"Found array with {arr.shape[0]} sample(s) in {name} while a "
                f"minimum of {need} is required"
            )

    def fit(self, X, y, **kwargs):
        if y is None:
            raise ValueError(
                f"This {type(self).__name__} estimator requires y to be passed, "
                "but the target y is None"
            )
        _check_extrapolate(self.extrapolate)
        Xa = asarray_2d(X)
        ya = asarray_2d(y)
        # reference check_array(y, ...) rejects non-finite targets (quantile.py:208-211)
        if np.isnan(ya).any():
            raise ValueError("Input y contains NaN.")
        self._min_samples_check(Xa, "X")
        self._min_samples_check(ya, "y")
        if Xa.shape[1] > 1:
            raise ValueError(
                f"Found array with {Xa.shape[1]} features while a maximum of 1 is required"
            )
        self._check_n_features(Xa, reset=True)
        state = qmr_fit(
            self._cell_tensor(Xa[:, 0]),
            self._cell_tensor(ya[:, 0]),
            extrapolate=self.extrapolate,
            n_endpoints=self.n_endpoints,
        )
        self._X_cdf = Cdf(state.x_pp.cpu().numpy(), state.x_vals.cpu().numpy())
        self._y_cdf = Cdf(state.y_pp.cpu().numpy(), state.y_vals.cpu().numpy())
        return self

    def _state_dev(self) -> QmrState:
        return QmrState(
            *(self._cell_tensor(a) for a in (*self._X_cdf, *self._y_cdf))
        )

    def predict(self, X, **kwargs):
        self._check_is_fitted()
        arr = asarray_2d(X)
        out = qmr_predict(
            self._state_dev(),
            self._cell_tensor(arr[:, 0]),
            extrapolate=self.extrapolate,
            n_endpoints=self.n_endpoints,
        )
        return out.cpu().numpy()


class EquidistantCdfMatcher(QuantileMappingReressor):
    """API of ``quantile.py:556-636`` (EDCDFm / QDM)."""

    _fit_attributes = ["_X_cdf", "_y_cdf"]

    def __init__(self, kind="difference", extrapolate=None, n_endpoints=10, max_ratio=None):
        # unlike the reference (quantile.py:582-584) params are validated at
        # fit time, per sklearn convention (no errors in __init__/set_params)
        self.kind = kind
        self.extrapolate = extrapolate
        self.n_endpoints = n_endpoints
        # MACA seems to have a max ratio for precip at 5.0 (quantile.py:588)
        self.max_ratio = max_ratio

    def fit(self, X, y, **kwargs):
        if self.kind not in ["difference", "ratio"]:
            raise NotImplementedError("kind must be either difference or ratio")
        return super().fit(X, y, **kwargs)

    def predict(self, X, **kwargs):
        self._check_is_fitted()
        arr = asarray_2d(X)
        out = edcdfm_predict(
            self._state_dev(),
            self._cell_tensor(arr[:, 0]),
            kind=self.kind,
            extrapolate=self.extrapolate,
            n_endpoints=self.n_endpoints,
            max_ratio=self.max_ratio,
        )
        return out.cpu().numpy()


class TrendAwareQuantileMappingRegressor(SingleCellEstimator):
    """API of ``quantile.py:639-716``: meta-estimator detrending X and y,
    fitting the inner quantile mapper on detrended data, and restoring the
    centered trendline plus a mean delta at predict time."""

    _fit_attributes = ["_X_mean_fit", "_y_mean_fit"]

    def __init__(self, qm_estimator=None, trend_transformer=None):
        self.qm_estimator = qm_estimator
        if trend_transformer is None:
            self.trend_transformer = LinearTrendTransformer()
        else:
            self.trend_transformer = trend_transformer

    def fit(self, X, y):
        Xa = asarray_2d(X)
        ya = asarray_2d(y)
        self._X_mean_fit = Xa.mean(axis=0)
        self._y_mean_fit = ya.mean(axis=0)

        # deep-copy the user-supplied transformer per series (quantile.py:676-680)
        y_trend = copy.deepcopy(self.trend_transformer)
        y_detrend = asarray_2d(y_trend.fit(ya).transform(ya))
        X_trend = copy.deepcopy(self.trend_transformer)
        x_detrend = asarray_2d(X_trend.fit(Xa).transform(Xa))

        self.qm_estimator.fit(x_detrend, y_detrend)
        return self

    def predict(self, X):
        self._check_is_fitted()
        Xa = asarray_2d(X)
        X_trend = copy.deepcopy(self.trend_transformer)  # quantile.py:698-699
        x_detrend = asarray_2d(X_trend.fit(Xa).transform(Xa))

        y_hat = np.asarray(self.qm_estimator.predict(x_detrend)).reshape(-1, 1)

        # delta: X (predict) - X (fit) + y -> projected change + historical obs mean
        delta = (Xa.mean(axis=0) - self._X_mean_fit) + self._y_mean_fit

        trendline = X_trend.trendline(Xa)
        trendline = trendline - trendline.mean()  # center at 0 (quantile.py:711)

        return y_hat + trendline + delta
