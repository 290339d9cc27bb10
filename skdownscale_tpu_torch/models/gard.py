"""GARD model family (analog methods).

Port of ``skdownscale_tpu/models/gard.py``, a re-design of the reference's
``pointwise_models/gard.py``, whose ``AnalogRegression.predict`` fits one
sklearn ``LogisticRegression`` + ``LinearRegression`` per time step per grid
cell in a Python loop (``gard.py:178-224``).  Here every query of every cell
is one row of a batch.

All three estimators return the reference's 3 columns
``['pred', 'exceedance_prob', 'prediction_error']`` (``gard.py:133-134``).
Replicated quirks:

* ``AnalogRegression`` exceedance probability is ``predict_proba(X)[0, 0]``,
  the probability of the *non*-exceedance class (``gard.py:210``), while
  ``PureRegression`` uses column 1 (``gard.py:467``).
* ``PureAnalog`` masked mean/weighted kinds propagate NaN when *any* analog
  is below threshold and then zero-fill ``pred`` only (``gard.py:329-343``):
  ``prediction_error`` keeps its NaNs.
* Where the reference *crashes* on single-class logistic fits (all analogs
  below threshold), the probability is 0.

Routes: the batched wrappers run the fused kernels of :mod:`..kernels.knn`
(K7, K8) on CUDA float32 tensors within their gates and the kernels' plain
versions on the CPU; :func:`pure_analog_predict` and
:func:`analog_regression_predict` are the torch route for CUDA tensors
outside the gates.  Brute-force exact kNN (index tie-broken) replaces the
KDTree; ``sample_analogs`` draws on the host with numpy.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from ..kernels import knn as _K
from ..ops.gather import take_rows
from ..ops.knn import knn
from ..ops.regression import (
    _psolve,
    linreg_fit,
    linreg_predict,
    logistic_fit,
    logistic_predict_proba,
    rmse,
)
from .base import SingleCellEstimator, asarray_2d

__all__ = [
    "AnalogBase",
    "AnalogRegression",
    "PureAnalog",
    "PureRegression",
    "PureRegressionState",
    "pure_analog_predict",
    "pure_analog_predict_batched",
    "analog_regression_predict",
    "analog_regression_predict_batched",
    "pure_regression_fit",
    "pure_regression_predict",
]

OUTPUT_NAMES = ["pred", "exceedance_prob", "prediction_error"]


# ======================================================================
# functional cores
# ======================================================================


def pure_analog_predict(X_train, y_train, Xq, rand_inds, *, k: int, kind: str, thresh=None):
    """``PureAnalog.predict`` core (``gard.py:273-346``): ``X_train``
    (..., n, f), ``y_train`` (..., n), ``Xq`` (..., m, f), ``rand_inds``
    (..., m) analog choices for ``sample_analogs`` (ignored by the other
    kinds) -> (..., m, 3)."""
    dist, inds = knn(X_train, Xq, k)
    analogs = take_rows(y_train[..., None], inds.flatten(-2))[..., 0].reshape(inds.shape)
    return _K.analog_outputs(analogs, dist, rand_inds, kind, thresh)


def _kernel_gate(X_train, k: int, max_features: int) -> bool:
    """The JAX package's gates for the fused kernels: float32, at most
    ``max_features`` features, k <= 4096."""
    return X_train.dtype == torch.float32 and X_train.shape[-1] <= max_features and k <= _K.MAX_K


def pure_analog_predict_batched(X_train, y_train, Xq, rand_inds, *, k: int, kind: str, thresh=None):
    """Cell-batched ``PureAnalog.predict``: (C, n, f)/(C, n)/(C, m, f) ->
    (C, m, 3).

    CPU tensors run the plain version of K7; CUDA float32 tensors with
    f <= 6 and k <= 4096 launch the fused K7 kernel (the cell's rows staged
    in shared memory, distances and the exact rank-k selection in two passes
    over them, then the analog statistics; no distance matrix in device
    memory); any other CUDA tensor (more features, a larger k, float64)
    takes the torch route, :func:`pure_analog_predict` (kNN by distance
    blocks and a sort, a gather, reductions)."""
    if X_train.device.type == "cuda" and not _kernel_gate(X_train, k, _K.MAX_FEATURES_PURE):
        return pure_analog_predict(X_train, y_train, Xq, rand_inds, k=k, kind=kind, thresh=thresh)
    if X_train.device.type == "cuda":
        rand_inds = rand_inds.to(torch.int32)
    return _K.pure_analog_stats(X_train, y_train, Xq, rand_inds, k=k, kind=kind, thresh=thresh)


def _ar_finish(stats, prob, mu, ybar, Xq, f: int):
    """Finish AnalogRegression from K8's sufficient statistics: the tiny
    per-query OLS solves and the rmse, replicating :func:`linreg_fit`'s
    centered pinv algebra (coef invariant to the per-cell x/y centering;
    pred and intercept shift back)."""
    tri_n = f * (f + 1) // 2
    sw = stats[..., 0]  # (C, m)
    swx = stats[..., 1 : 1 + f]
    tri = stats[..., 1 + f : 1 + f + tri_n]
    swy = stats[..., 1 + f + tri_n]
    swxy = stats[..., 2 + f + tri_n : 2 + 2 * f + tri_n]
    swy2 = stats[..., 2 + 2 * f + tri_n]

    # unpack the upper-triangular sum w x x^T
    cols = [[None] * f for _ in range(f)]
    t = 0
    for j in range(f):
        for l in range(j, f):
            cols[j][l] = cols[l][j] = tri[..., t]
            t += 1
    swxx = torch.stack([torch.stack(row, dim=-1) for row in cols], dim=-2)

    sw_safe = torch.where(sw > 0, sw, 1.0)
    xm = swx / sw_safe[..., None]
    ym = swy / sw_safe
    G = swxx - sw_safe[..., None, None] * xm[..., :, None] * xm[..., None, :]
    b = swxy - swx * ym[..., None]
    coef = _psolve(G, b)  # (C, m, f)
    intercept_c = ym - (coef * xm).sum(dim=-1)

    qc = Xq - mu  # (C, m, f): the same per-cell centering as the kernel
    pred = (coef * qc).sum(dim=-1) + intercept_c + ybar

    # sum w r^2 by quadratic expansion over the centered stats
    ssr = (
        swy2
        - 2.0 * (coef * swxy).sum(dim=-1)
        - 2.0 * intercept_c * swy
        + torch.einsum("...j,...jl,...l->...", coef, swxx, coef)
        + 2.0 * intercept_c * (coef * swx).sum(dim=-1)
        + intercept_c * intercept_c * sw
    )
    err = torch.sqrt(torch.clamp(ssr, min=0.0) / sw_safe)
    pred = torch.where(sw > 0, pred, float("nan"))
    err = torch.where(sw > 0, err, float("nan"))
    return torch.stack([pred, prob, err], dim=-1)


def analog_regression_predict_batched(X_train, y_train, Xq, *, k: int, thresh=None, logistic_n_iter=8):
    """Cell-batched ``AnalogRegression.predict``: (C, n, f)/(C, n)/(C, m, f)
    -> (C, m, 3).

    ``logistic_n_iter=8``: the ridge-damped Newton on the (f+1)-parameter
    local exceedance fit is converged by 6-8 iterations (the JAX package's
    ``test_gard_golden.py`` convergence test).

    CPU tensors run the plain version of K8 and :func:`_ar_finish`; CUDA
    float32 tensors with 1 <= f <= 5 and k <= 4096 launch the fused K8
    kernel (the two-pass selection over the cell's staged rows, then the
    local weighted-OLS sums and the logistic fit over the k members) and
    then :func:`_ar_finish`; any other CUDA tensor takes the
    torch route, :func:`analog_regression_predict`."""
    f = X_train.shape[-1]
    if X_train.device.type == "cuda" and not _kernel_gate(X_train, k, _K.MAX_FEATURES_REGRESSION):
        return analog_regression_predict(
            X_train, y_train, Xq, k=k, thresh=thresh, logistic_n_iter=logistic_n_iter
        )
    stats, prob, mu, ybar = _K.analog_regression_stats(
        X_train, y_train, Xq, k=k, thresh=thresh, n_iter=logistic_n_iter
    )
    return _ar_finish(stats, prob, mu, ybar, Xq, f)


def analog_regression_predict(X_train, y_train, Xq, *, k: int, thresh=None, logistic_n_iter=8):
    """``AnalogRegression.predict`` core (``gard.py:152-224``) on leading
    batch dims: per query, a local linear model on the k nearest analogs
    (optionally threshold-masked) plus a local logistic exceedance model."""
    inds = knn(X_train, Xq, k, return_distance=False)  # (..., m, k)
    f = X_train.shape[-1]
    # one row gather for predictors and target
    payload = torch.cat([X_train, y_train[..., None]], dim=-1)
    rows = take_rows(payload, inds.flatten(-2)).reshape(*inds.shape, f + 1)
    xk = rows[..., :f]  # (..., m, k, f)
    yk = rows[..., f]  # (..., m, k)
    exceed = yk > thresh if thresh is not None else torch.ones_like(yk, dtype=torch.bool)
    w = exceed.to(Xq.dtype)

    coef, intercept = linreg_fit(xk, yk, w)
    pred = (Xq * coef).sum(dim=-1) + intercept
    err = rmse(yk, linreg_predict(coef, intercept, xk), w)
    if thresh is not None:
        lcoef, lint = logistic_fit(xk, w, C=1.0, n_iter=logistic_n_iter)
        # predict_proba(X)[0, 0]: probability of class 0 (gard.py:210)
        p0 = 1.0 - logistic_predict_proba(lcoef, lint, Xq[..., None, :])[..., 0]
        prob = torch.where(exceed.all(dim=-1), 1.0, p0)  # gard.py:211-212
        prob = torch.where((~exceed).all(dim=-1), 0.0, prob)  # the reference crashes here
    else:
        prob = torch.ones_like(pred)
    return torch.stack([pred, prob, err], dim=-1)


class PureRegressionState(NamedTuple):
    lin_coef: torch.Tensor  # (..., f)
    lin_intercept: torch.Tensor  # (...)
    log_coef: torch.Tensor  # (..., f): zeros when no threshold
    log_intercept: torch.Tensor  # (...)
    fit_error: torch.Tensor  # (...)
    has_logistic: torch.Tensor  # (...) bool


def pure_regression_fit(X, y, *, thresh=None, logistic_n_iter=12) -> PureRegressionState:
    """``PureRegression.fit`` core (``gard.py:408-447``) on leading batch
    dims: X (..., T, f), y (..., T)."""
    f = X.shape[-1]
    batch = X.shape[:-2]
    if thresh is not None:
        exceed = y > thresh
        one_class = exceed.all(dim=-1) | (~exceed).all(dim=-1)
        w = exceed.to(X.dtype)
        lcoef, lint = logistic_fit(X, w, C=1.0, n_iter=logistic_n_iter)
        lcoef = torch.where(one_class[..., None], 0.0, lcoef)
        lint = torch.where(one_class, 0.0, lint)
        has_logistic = ~one_class
    else:
        has_logistic = torch.zeros(batch, dtype=torch.bool, device=X.device)
        lcoef = X.new_zeros((*batch, f))
        lint = X.new_zeros(batch)
        w = torch.ones_like(y)
    coef, intercept = linreg_fit(X, y, w)
    err = rmse(y, linreg_predict(coef, intercept, X), w)
    return PureRegressionState(coef, intercept, lcoef, lint, err, has_logistic)


def pure_regression_predict(state: PureRegressionState, Xq):
    """``PureRegression.predict`` core (``gard.py:449-493``): Xq (..., m, f)
    -> (..., m, 3)."""
    pred = linreg_predict(state.lin_coef, state.lin_intercept, Xq)
    # column 1: probability of exceedance (gard.py:467)
    p1 = logistic_predict_proba(state.log_coef, state.log_intercept, Xq)
    prob = torch.where(state.has_logistic[..., None], p1, torch.ones_like(p1))
    err = state.fit_error[..., None].expand_as(pred)
    return torch.stack([pred, prob, err], dim=-1)


# ======================================================================
# sklearn-compatible wrappers
# ======================================================================


class _BruteForceIndex:
    """Duck-type stand-in for the reference's fitted ``kdtree_`` attribute;
    queries run on ``owner``'s single-cell device."""

    def __init__(self, data, owner):
        self.data = data
        self._owner = owner

    def query(self, X, k=1, return_distance=True, **kwargs):
        cell = self._owner._cell_tensor
        res = knn(cell(self.data), cell(asarray_2d(X)), k, return_distance=return_distance)
        if return_distance:
            return res[0].cpu().numpy(), res[1].cpu().numpy()
        return res.cpu().numpy()


class AnalogBase(SingleCellEstimator):
    """Fit: store the training set and clamp ``k`` (``gard.py:55-87``)."""

    _fit_attributes = ["kdtree_", "X_", "y_", "k_"]
    n_outputs = 3
    output_names = OUTPUT_NAMES

    def fit(self, X, y):
        self._validate_data(X, y)
        Xa = asarray_2d(X)
        ya = asarray_2d(y)[:, 0]
        self._set_k(len(Xa))
        self.kdtree_ = _BruteForceIndex(Xa, self)
        self.X_ = Xa
        self.y_ = ya
        return self

    def _set_k(self, n: int):
        """``k_``: ``n_analogs``, clamped with a warning to the ``n``
        training rows."""
        if n >= self.n_analogs:
            self.k_ = int(self.n_analogs)
        else:
            warnings.warn("length of X is less than n_analogs, setting n_analogs = len(X)")
            self.k_ = n

    def _cell_batch(self, X):
        """The training set and the query rows as one-cell batches on the
        single-cell device."""
        return (
            self._cell_tensor(self.X_)[None],
            self._cell_tensor(self.y_)[None],
            self._cell_tensor(asarray_2d(X))[None],
        )

    def _maybe_df(self, out, X):
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        if hasattr(X, "iloc"):
            import pandas as pd

            return pd.DataFrame(out, columns=self.output_names)
        return out


class AnalogRegression(AnalogBase):
    """API of ``gard.py:101-224``."""

    def __init__(
        self,
        n_analogs: int = 200,
        thresh: float | None = None,
        kdtree_kwargs: dict[str, Any] | None = None,
        query_kwargs: dict[str, Any] | None = None,
        logistic_kwargs: dict[str, Any] | None = None,
        lr_kwargs: dict[str, Any] | None = None,
    ):
        self.n_analogs = n_analogs
        self.thresh = thresh
        self.kdtree_kwargs = kdtree_kwargs
        self.query_kwargs = query_kwargs
        self.logistic_kwargs = logistic_kwargs
        self.lr_kwargs = lr_kwargs

    def predict(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        out = analog_regression_predict_batched(*self._cell_batch(X), k=self.k_, thresh=self.thresh)
        return self._maybe_df(out[0], X)


class PureAnalog(AnalogBase):
    """API of ``gard.py:227-364``.

    ``random_state`` (additive parameter): seed for ``sample_analogs`` draws
    (the reference uses the numpy global RNG, ``gard.py:315``).
    """

    def __init__(
        self,
        n_analogs: int = 200,
        kind: str = "best_analog",
        thresh: float | None = None,
        kdtree_kwargs: dict[str, Any] | None = None,
        query_kwargs: dict[str, Any] | None = None,
        random_state: int | None = None,
    ):
        self.n_analogs = n_analogs
        self.kind = kind
        self.thresh = thresh
        self.kdtree_kwargs = kdtree_kwargs
        self.query_kwargs = query_kwargs
        self.random_state = random_state

    def _k_kind(self):
        """(k, kind) of a predict: best_analog, or any kind with one analog,
        is the nearest analog alone (``gard.py:299-302``)."""
        if self.kind == "best_analog" or self.n_analogs == 1:
            return 1, "best_analog"
        if self.kind not in _K.KINDS:
            raise ValueError(f"got unexpected kind {self.kind}")
        return self.k_, self.kind

    def predict(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        Xt, yt, Xq = self._cell_batch(X)
        m = Xq.shape[1]
        k, kind = self._k_kind()

        if kind == "sample_analogs":
            # host-side draw mirrors np.random.randint (gard.py:315)
            if self.random_state is None:
                rand = np.random.randint(0, k, m)
            else:
                rand = np.random.default_rng(self.random_state).integers(0, k, m)
        else:
            rand = np.zeros(m, dtype=np.int32)
        rand = torch.as_tensor(np.asarray(rand, dtype=np.int32), device=Xq.device)[None]
        out = pure_analog_predict_batched(Xt, yt, Xq, rand, k=k, kind=kind, thresh=self.thresh)
        return self._maybe_df(out[0], X)


class PureRegression(SingleCellEstimator):
    """API of ``gard.py:367-504``.

    Unlike the reference (which mutates ``self.thresh`` on single-class fits,
    ``gard.py:436``, a clone-semantics bug), the effective threshold lives in
    the fitted attribute ``thresh_``.
    """

    _fit_attributes = ["logistic_model_", "linear_model_", "fit_error_"]
    n_outputs = 3
    output_names = OUTPUT_NAMES

    def __init__(
        self,
        thresh: float | None = None,
        logistic_kwargs: dict[str, Any] | None = None,
        linear_kwargs: dict[str, Any] | None = None,
    ):
        self.thresh = thresh
        self.logistic_kwargs = logistic_kwargs
        self.linear_kwargs = linear_kwargs

    def fit(self, X, y):
        self._validate_data(X, y)
        Xa = asarray_2d(X)
        ya = asarray_2d(y)[:, 0]

        thresh = self.thresh
        if thresh is not None:
            exceed = ya > thresh
            if len(np.unique(exceed)) == 1:
                if not exceed.any():
                    # reference crashes fitting linear on zero rows (gard.py:441)
                    raise ValueError(
                        "all targets are below thresh; no samples to fit the linear model"
                    )
                warnings.warn(
                    "Found only one class while attempting logistic regression. "
                    "Falling back to thresh=None behavior"
                )
                thresh = None
        self.thresh_ = thresh

        state = pure_regression_fit(self._cell_tensor(Xa), self._cell_tensor(ya), thresh=thresh)
        self._state = PureRegressionState(*(t.cpu().numpy() for t in state))
        self.fit_error_ = float(self._state.fit_error)
        self.linear_model_ = {"coef_": self._state.lin_coef, "intercept_": float(self._state.lin_intercept)}
        self.logistic_model_ = (
            {"coef_": self._state.log_coef, "intercept_": float(self._state.log_intercept)}
            if thresh is not None
            else None
        )
        return self

    def predict(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        s = self._state
        state = PureRegressionState(
            *(self._cell_tensor(a) for a in s[:5]),
            torch.as_tensor(s.has_logistic, device=self._cell_device()),
        )
        out = pure_regression_predict(state, self._cell_tensor(asarray_2d(X)))
        if hasattr(X, "iloc"):
            import pandas as pd

            return pd.DataFrame(out.cpu().numpy(), columns=self.output_names)
        return out.cpu().numpy()
