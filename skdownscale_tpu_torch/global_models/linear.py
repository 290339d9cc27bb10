"""Pooled ("global") linear downscaling models.

Port of ``skdownscale_tpu/global_models/linear.py``: one weighted
least-squares problem pooled over every valid (cell, time) sample of a
grid, the reference roadmap's never-built ``global_models`` component
(``docs/roadmap.rst:59-65``).

On cell-sharded input (``parallel.mesh.shard_cells``, a ``ShardedCells``)
each shard computes its partial sufficient statistics and one
``all_reduce`` over the mesh sums them, the partitioned ``jnp.sum`` XLA
makes of the JAX version; the small (f, f) solve is replicated, and
per-cell intercepts stay on their shards.  The sums then differ from the
one-device fit only in the order of addition.

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
from ..parallel.mesh import ShardedCells, all_reduce, map_shards
from ..utils.device import as_tensor

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


def _masked(X, y):
    """(w, X and y zeroed where w is 0) of one block of cells."""
    w = _valid_mask(X, y)  # (C, T)
    return w, torch.where(w[..., None] > 0, X, 0.0), torch.where(w > 0, y, 0.0)


def global_linear_fit(X, y, *, cell_intercepts: bool = False) -> GlobalLinearState:
    """Pooled WLS fit.  ``X``: (C, T, f); ``y``: (C, T); both tensors, or
    both ``ShardedCells`` of one mesh.  Every sum is taken a block of cells
    at a time (one block, or one a shard) and the blocks' partial sums are
    added by ``all_reduce``; the (f, f) solve is replicated."""
    if isinstance(X, ShardedCells):
        mesh, dev = X.mesh, X.mesh.devices[0]
        parts = map_shards(_masked, X, y)

        def total(ts):
            return all_reduce(ts, mesh)

        def cells(ts):
            return ShardedCells(mesh, ts, X.shape[:1])
    else:
        dev = X.device
        parts = [_masked(X, y)]

        def total(ts):
            return ts[0]

        def cells(ts):
            return ts[0]

    # the count from integers: exact in float32 past 2**24 samples
    n = total([(w > 0).sum() for w, _, _ in parts]).to(X.dtype)
    if cell_intercepts:
        def centred(w, Xz, yz):
            wc = w.sum(dim=1)  # (C,)
            wc_safe = torch.where(wc > 0, wc, 1.0)
            xm = (Xz * w[..., None]).sum(dim=1) / wc_safe[:, None]  # (C, f)
            ym = (yz * w).sum(dim=1) / wc_safe  # (C,)
            # centre the zeroed copies: invalid samples stay finite (0*w)
            # instead of NaN-poisoning the contraction
            return wc, xm, ym, (Xz - xm[:, None, :]) * w[..., None], (yz - ym[:, None]) * w

        blocks = [centred(*p) for p in parts]
        grams = [_gram(Xc, yc) for *_, Xc, yc in blocks]
        coef = _psolve(total([G for G, _ in grams]), total([b for _, b in grams]))
        cell_intercept = cells([torch.where(wc > 0, ym - xm @ coef.to(wc.device), float("nan"))
                                for wc, xm, ym, _, _ in blocks])
        intercept = torch.zeros((), dtype=X.dtype, device=dev)
    else:
        n_safe = torch.where(n > 0, n, 1.0)
        xm = total([(Xz * w[..., None]).sum(dim=(0, 1)) for w, Xz, _ in parts]) / n_safe  # (f,)
        ym = total([(yz * w).sum() for w, _, yz in parts]) / n_safe
        grams = [_gram((Xz - xm.to(w.device)) * w[..., None], (yz - ym.to(w.device)) * w)
                 for w, Xz, yz in parts]
        coef = _psolve(total([G for G, _ in grams]), total([b for _, b in grams]))
        intercept = ym - xm @ coef
        cell_intercept = cells([torch.full(w.shape[:1], float("nan"), dtype=X.dtype, device=w.device)
                                for w, _, _ in parts])
    return GlobalLinearState(coef, intercept, cell_intercept, n)


def global_linear_predict(state: GlobalLinearState, X, *, cell_intercepts: bool = False):
    """Predict (C, T) from (C, T, f); cell-sharded in, cell-sharded out
    (the shared ``coef`` goes to each shard's device, no collective)."""
    if isinstance(X, ShardedCells):
        def shard(Xs, *icpt):
            base = torch.einsum("ctf,f->ct", Xs, state.coef.to(Xs.device))
            return base + (icpt[0][:, None] if cell_intercepts else state.intercept.to(Xs.device))

        return X.map(shard, *([state.cell_intercept] if cell_intercepts else []))
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
    tensor on the inputs' device.  Cell-sharded inputs
    (``parallel.mesh.shard_cells``) fit over the mesh and predict a
    ``ShardedCells``.
    """

    _fit_attributes = ["state_", "n_features_in_"]

    def __init__(self, cell_intercepts: bool = False, device="cuda"):
        self.cell_intercepts = cell_intercepts
        self.device = device

    def _coerce(self, X, y=None):
        if isinstance(X, ShardedCells):
            return X if y is None else (X, y)
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
        pred = self.predict(X)
        yt = self._coerce(X, y)[1]
        pred, yt = ((a.gather() if isinstance(a, ShardedCells) else a.cpu().numpy()) for a in (pred, yt))
        yt = yt.reshape(pred.shape)
        v = np.isfinite(yt) & np.isfinite(pred)
        ss_res = float(((yt[v] - pred[v]) ** 2).sum())
        ss_tot = float(((yt[v] - yt[v].mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
