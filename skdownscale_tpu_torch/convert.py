"""Carry fitted state between the JAX package and the port.

The JAX package's single-cell wrapper keeps its fitted state as numpy
arrays (``jax.tree_util.tree_map(np.asarray, state)``, ``bcsd.py:704``);
the grid runner's state is a ``BcsdState`` of device arrays with the same
three fields ``(pp, vals, aux)`` in the same flat layout; its lazy
(streaming) state is a ``BcsdLazyState`` ``(y, aux)``.  These helpers move
either state into the port's :class:`~.models.bcsd.BcsdState` /
:class:`~.models.bcsd.BcsdLazyState` and back, so a state fitted by one
package can be used by the other's predict.  The quantile family's states
(``QmState``, ``QmrState``, ``TrendState``) are named tuples of arrays with
the same fields in both packages and move the same way, as do the GARD
family's ``GardState`` (the grid's training set) and
``PureRegressionState``, the z-score and ARRM states (``ZScoreState``,
``ArrmState``) and the global models' (``GlobalLinearState``,
``GlobalQuantileState``).  A fitted JAX ``MBCn`` wrapper (whose state is
numpy arrays) becomes the port's ``MBCn`` with :func:`mbcn_state_from_jax`.
"""

from __future__ import annotations

import numpy as np
import torch

from .global_models.linear import GlobalLinearState
from .global_models.quantile import GlobalQuantileState
from .models.arrm import ArrmState
from .models.batched import GardState
from .models.bcsd import BcsdLazyState, BcsdState
from .models.gard import PureRegressionState
from .models.mbc import MBCn
from .models.quantile import QmrState, QmState
from .models.trend import TrendState
from .models.zscore import ZScoreState

__all__ = [
    "bcsd_state_from_jax",
    "bcsd_state_to_numpy",
    "bcsd_lazy_state_from_jax",
    "bcsd_lazy_state_to_numpy",
    "qm_state_from_jax",
    "qm_state_to_numpy",
    "qmr_state_from_jax",
    "qmr_state_to_numpy",
    "trend_state_from_jax",
    "gard_state_from_jax",
    "pure_regression_state_from_jax",
    "mbcn_state_from_jax",
    "zscore_state_from_jax",
    "arrm_state_from_jax",
    "global_linear_state_from_jax",
    "global_quantile_state_from_jax",
    "state_to_numpy",
]


def _tensors(arrays, device, dtype):
    dev = torch.device(device)
    return (torch.tensor(np.asarray(a), dtype=dtype, device=dev) for a in arrays)


def state_to_numpy(state):
    """Any fitted state of the port (a named tuple of tensors) -> a tuple of
    numpy arrays in its field order."""
    return tuple(t.detach().cpu().numpy() for t in state)


bcsd_state_to_numpy = bcsd_lazy_state_to_numpy = state_to_numpy
qm_state_to_numpy = qmr_state_to_numpy = state_to_numpy


def bcsd_state_from_jax(pp, vals, aux, device="cpu", dtype=None) -> BcsdState:
    """Numpy ``(pp, vals, aux)`` -> the port's ``BcsdState`` on ``device``
    (in ``dtype``, default the arrays' own)."""
    return BcsdState(*_tensors((pp, vals, aux), device, dtype))


def bcsd_lazy_state_from_jax(y, aux, device="cpu", dtype=None) -> BcsdLazyState:
    """Numpy ``(y, aux)`` of a JAX ``BcsdLazyState`` -> the port's
    ``BcsdLazyState`` on ``device`` (in ``dtype``, default the arrays' own)."""
    return BcsdLazyState(*_tensors((y, aux), device, dtype))


def qm_state_from_jax(cdf_pp, cdf_vals, trend_slope, trend_intercept, device="cpu", dtype=None) -> QmState:
    """Numpy fields of a JAX ``QmState`` -> the port's ``QmState`` on ``device``."""
    return QmState(*_tensors((cdf_pp, cdf_vals, trend_slope, trend_intercept), device, dtype))


def qmr_state_from_jax(x_pp, x_vals, y_pp, y_vals, device="cpu", dtype=None) -> QmrState:
    """Numpy fields of a JAX ``QmrState`` -> the port's ``QmrState`` on ``device``."""
    return QmrState(*_tensors((x_pp, x_vals, y_pp, y_vals), device, dtype))


def trend_state_from_jax(slope, intercept, device="cpu", dtype=None) -> TrendState:
    """Numpy fields of a JAX ``TrendState`` -> the port's ``TrendState`` on ``device``."""
    return TrendState(*_tensors((slope, intercept), device, dtype))


def gard_state_from_jax(X_train, y_train, device="cpu", dtype=None) -> GardState:
    """Numpy fields of a JAX ``GardState`` -> the port's ``GardState`` on ``device``."""
    return GardState(*_tensors((X_train, y_train), device, dtype))


def pure_regression_state_from_jax(
    lin_coef, lin_intercept, log_coef, log_intercept, fit_error, has_logistic, device="cpu", dtype=None
) -> PureRegressionState:
    """Numpy fields of a JAX ``PureRegressionState`` -> the port's
    ``PureRegressionState`` on ``device`` (``has_logistic`` stays bool)."""
    floats = _tensors((lin_coef, lin_intercept, log_coef, log_intercept, fit_error), device, dtype)
    return PureRegressionState(
        *floats, torch.tensor(np.asarray(has_logistic), dtype=torch.bool, device=torch.device(device))
    )


def mbcn_state_from_jax(model) -> MBCn:
    """A fitted JAX ``MBCn`` -> the port's ``MBCn`` with the same parameters
    and fitted state: ``x_hist_``, ``y_obs_``, ``rotations_``,
    ``n_features_in_``, the columns and, for ``group="month"``, the month
    labels of the calibration and observation blocks.  Reads the model's
    numpy attributes only; it runs on the port's ``single_cell_device``."""
    out = MBCn(**model.get_params())
    out.x_hist_ = np.asarray(model.x_hist_, dtype=np.float64)
    out.y_obs_ = np.asarray(model.y_obs_, dtype=np.float64)
    out.rotations_ = np.asarray(model.rotations_, dtype=np.float64)
    out.n_features_in_ = int(model.n_features_in_)
    out._columns = list(model._columns)
    if model.group == "month":
        out._months_hist = np.asarray(model._months_hist)
        out._months_obs = np.asarray(model._months_obs)
    return out


def zscore_state_from_jax(shift, scale, x_mean, x_std, y_mean, y_std, device="cpu", dtype=None) -> ZScoreState:
    """Numpy fields of a JAX ``ZScoreState`` (a grid's (C, D-1) or a
    wrapper's ``_state``) -> the port's ``ZScoreState`` on ``device``."""
    return ZScoreState(*_tensors((shift, scale, x_mean, x_std, y_mean, y_std), device, dtype))


def arrm_state_from_jax(breaks, beta, x_min, x_max, device="cpu") -> ArrmState:
    """Numpy fields of a JAX ``ArrmState`` -> the port's ``ArrmState`` on
    ``device``, in float64 (the port's ARRM state is float64 on every
    device)."""
    return ArrmState(*_tensors((breaks, beta, x_min, x_max), device, torch.float64))


def global_linear_state_from_jax(coef, intercept, cell_intercept, n_samples, device="cpu",
                                 dtype=None) -> GlobalLinearState:
    """Numpy fields of a JAX ``GlobalLinearState`` -> the port's
    ``GlobalLinearState`` on ``device``."""
    return GlobalLinearState(*_tensors((coef, intercept, cell_intercept, n_samples), device, dtype))


def global_quantile_state_from_jax(pp, x_ladder, y_ladder, n_x, n_y, device="cpu",
                                   dtype=None) -> GlobalQuantileState:
    """Numpy fields of a JAX ``GlobalQuantileState`` -> the port's
    ``GlobalQuantileState`` on ``device`` (the sample counts stay integers)."""
    dev = torch.device(device)
    pp, xl, yl = _tensors((pp, x_ladder, y_ladder), dev, dtype)
    counts = (torch.tensor(np.asarray(n), dtype=torch.int64, device=dev) for n in (n_x, n_y))
    return GlobalQuantileState(pp, xl, yl, *counts)
