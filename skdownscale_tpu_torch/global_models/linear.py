"""Pooled ("global") linear downscaling models.

Port of ``skdownscale_tpu/global_models/linear.py``: one weighted
least-squares problem pooled over every valid (cell, time) sample of a
grid, the reference roadmap's never-built ``global_models`` component
(``docs/roadmap.rst:59-65``), on one device.

Two intercept modes:

* ``cell_intercepts=False``: one shared intercept, classic pooled OLS;
* ``cell_intercepts=True``: per-cell intercepts (the fixed-effects, or
  within, estimator): slopes from within-cell-centred covariances, then
  ``intercept_c = mean_c(y) - coef . mean_c(x)``.

Any sample whose target or any feature is non-finite gets weight 0, and
all-NaN (ocean) cells give NaN per-cell intercepts and predictions.

The contractions run in full float32 on the card (TF32 is off, as the JAX
package ran them at ``Precision.HIGHEST``), each cell's (f, f) and (f,)
sums first and then a tree sum over the cells, so no float32 accumulator
runs over the whole pooled sample.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.regression import _psolve
from ._device import as_tensor

__all__ = [
    "GlobalLinearState",
    "GlobalLinearRegressor",
    "global_linear_fit",
    "global_linear_predict",
]


class GlobalLinearState(NamedTuple):
    coef: torch.Tensor  # (f,) shared slopes
    intercept: torch.Tensor  # () shared intercept (global mode) else 0
    cell_intercept: torch.Tensor  # (C,) per-cell intercepts (NaN where unused/empty)
    n_samples: torch.Tensor  # () pooled valid-sample count


def _valid_mask(X, y):
    return (torch.isfinite(y) & torch.isfinite(X).all(dim=-1)).to(X.dtype)


def _gram(Xc, yc):
    """Pooled ``Xc^T Xc`` (f, f) and ``Xc^T yc`` (f,) over (C, T)."""
    G = torch.einsum("cti,ctj->cij", Xc, Xc).sum(dim=0)
    b = torch.einsum("cti,ct->ci", Xc, yc).sum(dim=0)
    return G, b


def global_linear_fit(X, y, *, cell_intercepts: bool = False) -> GlobalLinearState:
    """Pooled WLS fit.  ``X``: (C, T, f); ``y``: (C, T)."""
    w = _valid_mask(X, y)  # (C, T)
    yz = torch.where(w > 0, y, 0.0)
    Xz = torch.where(w[..., None] > 0, X, 0.0)
    # the count from integers: exact in float32 past 2**24 samples
    n = (w > 0).sum().to(X.dtype)
    n_safe = torch.where(n > 0, n, 1.0)

    if cell_intercepts:
        wc = w.sum(dim=1)  # (C,)
        wc_safe = torch.where(wc > 0, wc, 1.0)
        xm = (Xz * w[..., None]).sum(dim=1) / wc_safe[:, None]  # (C, f)
        ym = (yz * w).sum(dim=1) / wc_safe  # (C,)
        # centre the zeroed copies: invalid samples stay finite (0*w) instead
        # of NaN-poisoning the contraction
        Xc = (Xz - xm[:, None, :]) * w[..., None]
        yc = (yz - ym[:, None]) * w
        coef = _psolve(*_gram(Xc, yc))
        cell_intercept = torch.where(wc > 0, ym - xm @ coef, float("nan"))
        intercept = torch.zeros((), dtype=X.dtype, device=X.device)
    else:
        xm = (Xz * w[..., None]).sum(dim=(0, 1)) / n_safe  # (f,)
        ym = (yz * w).sum() / n_safe
        Xc = (Xz - xm) * w[..., None]
        yc = (yz - ym) * w
        coef = _psolve(*_gram(Xc, yc))
        intercept = ym - xm @ coef
        cell_intercept = torch.full(X.shape[:1], float("nan"), dtype=X.dtype, device=X.device)
    return GlobalLinearState(coef, intercept, cell_intercept, n)


def global_linear_predict(state: GlobalLinearState, X, *, cell_intercepts: bool = False):
    """Predict (C, T) from (C, T, f)."""
    base = torch.einsum("ctf,f->ct", X, state.coef)
    if cell_intercepts:
        return base + state.cell_intercept[:, None]
    return base + state.intercept


class GlobalLinearRegressor:
    """sklearn-flavoured wrapper around the pooled fit.

    Parameters
    ----------
    cell_intercepts : bool
        False (default): one shared intercept.  True: per-cell intercepts
        (fixed-effects estimator).
    device : str or torch.device
        Where numpy inputs go: the card by default (float32), ``"cpu"`` for
        the input's dtype.  Tensors stay on their own device.  Without a
        card a CUDA device raises.

    ``fit(X, y)`` takes ``X`` (cells, time, features) and ``y`` (cells,
    time); 2-D ``X`` is one cell.  ``predict`` returns a (cells, time)
    tensor on the inputs' device.
    """

    _fit_attributes = ["state_", "n_features_in_"]

    def __init__(self, cell_intercepts: bool = False, device="cuda"):
        self.cell_intercepts = cell_intercepts
        self.device = device

    def _coerce(self, X, y=None):
        X = as_tensor(X, self.device, type(self).__name__)
        if X.ndim == 2:  # (T, f) single cell
            X = X[None]
        if y is None:
            return X
        y = as_tensor(y, X.device, type(self).__name__).to(X.dtype)
        return X, y[None] if y.ndim == 1 else y

    def fit(self, X, y):
        X, y = self._coerce(X, y)
        self.n_features_in_ = X.shape[-1]
        self.state_ = global_linear_fit(X, y, cell_intercepts=self.cell_intercepts)
        return self

    def predict(self, X):
        X = self._coerce(X)
        return global_linear_predict(self.state_, X, cell_intercepts=self.cell_intercepts)

    # sklearn-ish param protocol (clone-compatible)
    def get_params(self, deep: bool = True):
        return {"cell_intercepts": self.cell_intercepts, "device": self.device}

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self

    def score(self, X, y):
        pred = self.predict(X).cpu().numpy()
        yt = self._coerce(X, y)[1].cpu().numpy().reshape(pred.shape)
        v = np.isfinite(yt) & np.isfinite(pred)
        ss_res = float(((yt[v] - pred[v]) ** 2).sum())
        ss_tot = float(((yt[v] - yt[v].mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
