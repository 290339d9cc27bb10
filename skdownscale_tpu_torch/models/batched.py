"""Batched execution registry: ``(cells, time)`` implementations by
estimator type.

Port of ``skdownscale_tpu/models/batched.py`` with its BCSD entry.  Where
the reference runs one Python estimator object per grid cell
(``pointwise_models/core.py:86-96``), an estimator registered here fits and
predicts every cell of a ``(cells, time)`` tensor at once; its fitted state
is a tuple of ``(cells, ...)`` tensors on the grid's device.

The monthly BCSD entry takes the dense path at every cell count: the JAX
package's streaming threshold was set for a 16 GB chip and is re-derived
for the H100's 80 GB in later work (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import bcsd as _bcsd

__all__ = ["register", "supports_batched", "batched_fit", "batched_predict", "batched_attrs"]


class _Impl(NamedTuple):
    fit: Callable  # (model, index_fit, X (C,T,F), y (C,T)|None) -> state
    predict: Callable  # (model, state, index_fit, X, index) -> (C,T)
    attrs: Callable  # (model, state) -> dict[str, np.ndarray (C,...)]


_REGISTRY: dict[type, _Impl] = {}


def register(cls, impl: _Impl) -> None:
    """Register a batched implementation for an estimator class (resolved
    through the MRO at dispatch time)."""
    _REGISTRY[cls] = impl


def _lookup(model) -> _Impl | None:
    for klass in type(model).__mro__:
        if klass in _REGISTRY:
            return _REGISTRY[klass]
    return None


def supports_batched(model) -> bool:
    return _lookup(model) is not None


def batched_fit(model, index_fit, X, y):
    return _lookup(model).fit(model, index_fit, X, y)


def batched_predict(model, state, index_fit, X, index):
    return _lookup(model).predict(model, state, index_fit, X, index)


def batched_attrs(model, state) -> dict:
    return _lookup(model).attrs(model, state)


def _single(X):
    """(C, T, F) -> (C, T), asserting a single feature."""
    if X.shape[-1] != 1:
        raise ValueError(f"this model supports 1 feature, found {X.shape[-1]}")
    return X[..., 0]


# ----------------------------------------------------------------------
# BCSD
# ----------------------------------------------------------------------


def _bcsd_fit(model, index_fit, X, y):
    fg = model._fit_groups(index_fit)
    p = model._qm_params()
    return _bcsd.bcsd_fit(
        _single(X), y, fg,
        with_x_climo=model._with_x_climo, alpha=p["alpha"], beta=p["beta"], detrend=p["detrend"],
    )


def _bcsd_predict(model, state, index_fit, X, index):
    fg = model._fit_groups(index_fit)
    plan = model._predict_plan(fg, index)
    p = model._qm_params()
    return _bcsd.bcsd_predict(
        state,
        _single(X),
        plan,
        variable="temperature" if model._with_x_climo else "precipitation",
        return_anoms=bool(model.return_anoms),
        **{k: p[k] for k in ("alpha", "beta", "extrapolate", "n_endpoints", "detrend")},
    )


def _bcsd_attrs(model, state):
    climo = state.aux.reshape(*state.aux.shape[:-1], 4, -1)[..., 2, :]
    return {"y_climo_": climo.cpu().numpy()}


register(_bcsd.BcsdBase, _Impl(_bcsd_fit, _bcsd_predict, _bcsd_attrs))
