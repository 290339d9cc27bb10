"""Batched execution registry: ``(cells, time)`` implementations by
estimator type.

Port of ``skdownscale_tpu/models/batched.py`` with all its entries: BCSD,
trend, the quantile family, z-score, ARRM and GARD.  Where the reference runs one Python estimator
object per grid cell (``pointwise_models/core.py:86-96``), an estimator
registered here fits, predicts and transforms every cell of a
``(cells, time)`` tensor at once; its fitted state is a tuple (or dict) of
``(cells, ...)`` tensors on the grid's device.

The BCSD entry takes the streaming formulation (lazy fit, group-chunked
predict) for the daily flavor at every cell count and for the monthly
flavor from :data:`STREAMING_CELL_THRESHOLD` cells up; below it the monthly
flavor takes the dense path.  An estimator that is not registered here (or
whose ``accepts`` refuses it) takes ``PointWiseDownscaler``'s per-cell
object loop.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import arrm as _arrm
from . import bcsd as _bcsd
from . import gard as _gard
from . import quantile as _q
from . import trend as _t
from . import zscore as _z

__all__ = [
    "STREAMING_CELL_THRESHOLD",
    "GROUP_CHUNK",
    "ZSCORE_PASS_ELEMENTS",
    "register",
    "supports_batched",
    "batched_fit",
    "batched_predict",
    "batched_transform",
    "batched_attrs",
    "GardState",
    "pass_shard",
    "cat_cells",
    "split_cells",
    "tree_to",
]


class _Impl(NamedTuple):
    fit: Callable  # (model, index_fit, X (C,T,F), y (C,T)|None) -> state
    predict: Callable | None  # (model, state, index_fit, X, index) -> (C,T[,O])
    transform: Callable | None  # (model, state, index_fit, X, index, direction) -> (C,T)
    attrs: Callable | None  # (model, state) -> dict[str, np.ndarray (C,...)]
    accepts: Callable | None = None  # (model) -> bool: this instance batchable?


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
    impl = _lookup(model)
    return impl is not None and (impl.accepts is None or impl.accepts(model))


# The device pass that a batched call's cells belong to when they are one
# shard of it: (the shard's first cell in the pass, cells in the pass).  A
# sharded runner sets it (pass_shard); the streaming choice and GARD's
# sample draw read it, so the cells of a shard behave as they do in the
# whole pass.
_PASS: contextvars.ContextVar = contextvars.ContextVar("pass_shard", default=None)


@contextlib.contextmanager
def pass_shard(offset: int, n_pass: int):
    """Batched calls inside run one shard of a pass of ``n_pass`` cells,
    the shard starting at cell ``offset`` of the pass."""
    token = _PASS.set((offset, n_pass))
    try:
        yield
    finally:
        _PASS.reset(token)


def _pass_of(n_cells: int) -> tuple[int, int]:
    """(offset, cells of the pass) of a call on ``n_cells`` cells."""
    return _PASS.get() or (0, n_cells)


def _map_tree(fn, node, shared=False):
    """``fn(tensor, shared)`` on each tensor of a state tree; ``shared``
    marks the leaves of a NamedTuple's ``shared_fields`` (no cell axis)."""
    if isinstance(node, torch.Tensor):
        return fn(node, shared)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        names = getattr(type(node), "shared_fields", ())
        return type(node)(*(_map_tree(fn, v, shared or f in names) for f, v in zip(node._fields, node)))
    if isinstance(node, (tuple, list)):
        return type(node)(_map_tree(fn, v, shared) for v in node)
    if isinstance(node, dict):
        return {k: _map_tree(fn, v, shared) for k, v in node.items()}
    return node


def cat_cells(states):
    """One state, on the host, from the states of consecutive cell blocks:
    every tensor concatenated on its leading (cell) axis, except the
    NamedTuple fields a state class lists in ``shared_fields``, taken from
    the first block."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([s.cpu() for s in states])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        names = getattr(type(first), "shared_fields", ())
        return type(first)(*(tree_to(v, "cpu") if f in names else cat_cells([s[i] for s in states])
                             for i, (f, v) in enumerate(zip(first._fields, first))))
    if isinstance(first, (tuple, list)):
        return type(first)(cat_cells(list(z)) for z in zip(*states))
    if isinstance(first, dict):
        return {k: cat_cells([s[k] for s in states]) for k in first}
    return first


def split_cells(state, sizes):
    """The inverse of :func:`cat_cells`: ``state`` split into blocks of
    ``sizes`` cells (views of it), the shared fields in every block."""
    n = sum(sizes)

    def check(t, shared):
        if not shared and (t.dim() == 0 or t.shape[0] != n):
            raise ValueError(f"a state leaf of shape {tuple(t.shape)} has no leading axis of {n} cells")
        return t

    _map_tree(check, state)
    bounds = np.cumsum([0, *sizes])
    return [_map_tree(lambda t, shared, lo=lo, hi=hi: t if shared else t[lo:hi], state)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def tree_to(state, device):
    """A state tree with every tensor on ``device``."""
    return _map_tree(lambda t, shared: t.to(device), state)


def batched_fit(model, index_fit, X, y):
    return _lookup(model).fit(model, index_fit, X, y)


def batched_predict(model, state, index_fit, X, index):
    return _lookup(model).predict(model, state, index_fit, X, index)


def batched_transform(model, state, index_fit, X, index, direction="transform"):
    return _lookup(model).transform(model, state, index_fit, X, index, direction)


def batched_attrs(model, state) -> dict:
    impl = _lookup(model)
    if impl is None or impl.attrs is None:
        return {}
    return impl.attrs(model, state)


def _single(X):
    """(C, T, F) -> (C, T), asserting a single feature."""
    if X.shape[-1] != 1:
        raise ValueError(f"this model supports 1 feature, found {X.shape[-1]}")
    return X[..., 0]


# ----------------------------------------------------------------------
# LinearTrendTransformer
# ----------------------------------------------------------------------


def _trend_fit(model, index_fit, X, y):
    # (C, T, F) -> per (cell, feature) slope/intercept
    return _t.trend_fit(torch.movedim(X, 1, -1))  # (C, F, T) -> state (C, F)


def _trend_transform(model, state, index_fit, X, index, direction):
    line = torch.movedim(_t.trend_line(state, X.shape[1], X.dtype), -1, 1)  # (C, T, F)
    return _single(X - line) if direction == "transform" else _single(X + line)


register(
    _t.LinearTrendTransformer,
    _Impl(
        _trend_fit,
        None,
        _trend_transform,
        lambda model, state: {
            "slope_": state.slope.cpu().numpy(),
            "intercept_": state.intercept.cpu().numpy(),
        },
    ),
)


# ----------------------------------------------------------------------
# QuantileMapper
# ----------------------------------------------------------------------


def _qm_fit(model, index_fit, X, y):
    p = model._qt_params()
    return _q.qm_fit(_single(X), detrend=bool(model.detrend), alpha=p["alpha"], beta=p["beta"])


def _qm_transform(model, state, index_fit, X, index, direction):
    if direction != "transform":
        raise NotImplementedError("QuantileMapper has no inverse_transform in the reference")
    p = model._qt_params()
    return _q.qm_transform(state, _single(X), detrend=bool(model.detrend), **p)


register(_q.QuantileMapper, _Impl(_qm_fit, None, _qm_transform, None))


# ----------------------------------------------------------------------
# CunnaneTransformer
# ----------------------------------------------------------------------


def _cunnane_fit(model, index_fit, X, y):
    return _q.cunnane_fit(_single(X), model.alpha, model.beta)


def _cunnane_transform(model, state, index_fit, X, index, direction):
    fn = _q.cunnane_transform if direction == "transform" else _q.cunnane_inverse
    return fn(state, _single(X), model.extrapolate, model.n_endpoints)


register(_q.CunnaneTransformer, _Impl(_cunnane_fit, None, _cunnane_transform, None))


# ----------------------------------------------------------------------
# QuantileMappingReressor / EquidistantCdfMatcher
# ----------------------------------------------------------------------


def _qmr_fit(model, index_fit, X, y):
    return _q.qmr_fit(_single(X), y, extrapolate=model.extrapolate, n_endpoints=model.n_endpoints)


def _qmr_predict(model, state, index_fit, X, index):
    return _q.qmr_predict(
        state, _single(X), extrapolate=model.extrapolate, n_endpoints=model.n_endpoints
    )


register(_q.QuantileMappingReressor, _Impl(_qmr_fit, _qmr_predict, None, None))


def _edcdfm_predict(model, state, index_fit, X, index):
    return _q.edcdfm_predict(
        state,
        _single(X),
        kind=model.kind,
        extrapolate=model.extrapolate,
        n_endpoints=model.n_endpoints,
        max_ratio=model.max_ratio,
    )


register(_q.EquidistantCdfMatcher, _Impl(_qmr_fit, _edcdfm_predict, None, None))


# ----------------------------------------------------------------------
# TrendAwareQuantileMappingRegressor
# ----------------------------------------------------------------------


def _ta_trend_opts(model):
    """(fit_intercept, positive) of the model's LinearTrendTransformer."""
    return _t.LinearTrendTransformer._lr_options(model.trend_transformer)


def _ta_accepts(model):
    """The batched path requires a plain ``LinearTrendTransformer`` (with
    supported ``lr_kwargs``) and a batchable inner qm_estimator; anything
    else (a trend transformer of another class, say) takes the runner's
    exact per-cell object loop, as in the JAX package."""
    tt = model.trend_transformer
    if type(tt) is not _t.LinearTrendTransformer:
        return False
    try:
        _ta_trend_opts(model)
    except ValueError:
        return False
    return supports_batched(model.qm_estimator)


def _ta_fit(model, index_fit, X, y):
    x = _single(X)
    fit_intercept, positive = _ta_trend_opts(model)
    x_tr = _t.trend_fit_opts(x, fit_intercept, positive)
    y_tr = _t.trend_fit_opts(y, fit_intercept, positive)
    x_det = x - _t.trend_line(x_tr, x.shape[1], x.dtype)
    y_det = y - _t.trend_line(y_tr, y.shape[1], y.dtype)
    inner = batched_fit(model.qm_estimator, index_fit, x_det[..., None], y_det)
    return {"inner": inner, "x_mean": x.mean(dim=1), "y_mean": y.mean(dim=1)}


def _ta_predict(model, state, index_fit, X, index):
    x = _single(X)
    fit_intercept, positive = _ta_trend_opts(model)
    tr = _t.trend_fit_opts(x, fit_intercept, positive)
    line = _t.trend_line(tr, x.shape[1], x.dtype)
    x_det = x - line
    y_hat = batched_predict(model.qm_estimator, state["inner"], index_fit, x_det[..., None], index)
    delta = (x.mean(dim=1) - state["x_mean"]) + state["y_mean"]
    trendline = line - line.mean(dim=1, keepdim=True)
    return y_hat + trendline + delta[:, None]


register(
    _q.TrendAwareQuantileMappingRegressor, _Impl(_ta_fit, _ta_predict, None, None, _ta_accepts)
)


# ----------------------------------------------------------------------
# BCSD
# ----------------------------------------------------------------------


# Cells from which the monthly BCSD takes the streaming formulation.  The
# dense path's peak device memory is 29.7 KiB a cell at T=480 (3.712 GiB at
# 131,072 cells on an H100, PERF.md); 80 GB less a fifth of headroom (the
# allocator's slack and the prefetched next chunk) holds about 2.1M such
# cells, so the dense path keeps every grid below 2M cells.  The JAX
# package's 200,000 was set for a 16 GB chip.  The daily flavor always
# streams (27x window expansion).
STREAMING_CELL_THRESHOLD = 2_000_000

# Transform groups per chunk of the streaming loop, by flavor.  The chunk
# bounds the loop's live (C, Gc*L) temporaries; the monthly flavor streams
# only at continental cell counts, so it takes a smaller chunk than the
# always-streaming daily flavor.
GROUP_CHUNK = {"daily": 8, "monthly": 3}


def _bcsd_fit(model, index_fit, X, y):
    fg = model._fit_groups(index_fit)
    if model._timestep_kind == "daily" or _pass_of(X.shape[0])[1] >= STREAMING_CELL_THRESHOLD:
        return _bcsd.bcsd_fit_lazy(_single(X), y, fg, with_x_climo=model._with_x_climo)
    p = model._qm_params()
    return _bcsd.bcsd_fit(
        _single(X), y, fg,
        with_x_climo=model._with_x_climo, alpha=p["alpha"], beta=p["beta"], detrend=p["detrend"],
    )


def _bcsd_predict(model, state, index_fit, X, index):
    fg = model._fit_groups(index_fit)
    plan = model._predict_plan(fg, index)
    model._check_anoms(plan)
    p = model._qm_params()
    kw = dict(
        variable="temperature" if model._with_x_climo else "precipitation",
        return_anoms=bool(model.return_anoms),
        **{k: p[k] for k in ("alpha", "beta", "extrapolate", "n_endpoints", "detrend")},
    )
    if isinstance(state, _bcsd.BcsdLazyState):
        return _bcsd.bcsd_predict_streaming(
            state, _single(X), plan, group_chunk=GROUP_CHUNK[model._timestep_kind], **kw
        )
    return _bcsd.bcsd_predict(state, _single(X), plan, **kw)


def _bcsd_attrs(model, state):
    if isinstance(state, _bcsd.BcsdLazyState):
        climo = state.aux.reshape(*state.aux.shape[:-1], 2, -1)[..., 0, :]
    else:
        climo = state.aux.reshape(*state.aux.shape[:-1], 4, -1)[..., 2, :]
    return {"y_climo_": climo.cpu().numpy()}


register(_bcsd.BcsdBase, _Impl(_bcsd_fit, _bcsd_predict, None, _bcsd_attrs))


# ----------------------------------------------------------------------
# ZScore
# ----------------------------------------------------------------------


# (cell, day) elements of one z-score pass.  A grid runner's fit + predict
# peaks at 39.5 device bytes an element (17.604 GiB at 65,536 cells x
# 7,305 days on an H100, PERF.md section 5); 80 GB less a fifth of headroom
# (the allocator's slack, the prefetched next chunk) holds about 1.6e9,
# some 219,000 cells of 20 daily years.  The JAX package's single pass of
# 65,536 such cells (bench.py:434-440) was set for a 16 GB chip.  A larger
# grid runs in passes of ZSCORE_PASS_ELEMENTS // T cells (its inputs and
# output stay whole: bound them with the runner's cell_chunk_size).
ZSCORE_PASS_ELEMENTS = 1_600_000_000


def _cell_passes(C: int, T: int):
    step = max(1, ZSCORE_PASS_ELEMENTS // max(T, 1))
    return [slice(i, i + step) for i in range(0, max(C, 1), step)]


def _zscore_fit(model, index_fit, X, y):
    idx, mask = _z.build_year_doy_table(index_fit)
    x = _single(X)
    parts = [_z.zscore_fit(x[s], y[s], idx, mask, window=model.window_width)
             for s in _cell_passes(*x.shape)]
    return _z.ZScoreState(*(torch.cat(f) for f in zip(*parts)))


def _zscore_predict(model, state, index_fit, X, index):
    x = _single(X)
    inds = _z.expand_indices(x.shape[1])
    return torch.cat([
        _z.zscore_predict(_z.ZScoreState(*(f[s] for f in state)), x[s], inds,
                          window=model.window_width)[0]
        for s in _cell_passes(*x.shape)
    ])


register(
    _z.ZScoreRegressor,
    _Impl(
        _zscore_fit,
        _zscore_predict,
        None,
        lambda model, state: {"shift_": state.shift.cpu().numpy(), "scale_": state.scale.cpu().numpy()},
    ),
)


# ----------------------------------------------------------------------
# ARRM / PiecewiseLinearRegression
# ----------------------------------------------------------------------


def _arrm_fit(model, index_fit, X, y):
    return _arrm.arrm_fit_batched(
        _single(X), y, fit_option=model.fit_option, n_segments=int(model.n_segments)
    )


def _arrm_predict(model, state, index_fit, X, index):
    return _arrm.arrm_predict_batched(state, _single(X))


def _arrm_attrs(model, state):
    # pwlf-style break vector [x_min, interior..., x_max] per cell (ref
    # arrm.py:154, the single-cell wrapper's fit_breaks_)
    fb = torch.cat([state.x_min[:, None], state.breaks, state.x_max[:, None]], dim=1)
    return {"fit_breaks_": fb.cpu().numpy()}


register(_arrm.PiecewiseLinearRegression, _Impl(_arrm_fit, _arrm_predict, None, _arrm_attrs))


# ----------------------------------------------------------------------
# GARD
# ----------------------------------------------------------------------


class GardState(NamedTuple):
    X_train: torch.Tensor  # (C, T, F)
    y_train: torch.Tensor  # (C, T)


def _gard_fit(model, index_fit, X, y):
    model._set_k(X.shape[1])
    return GardState(X, y)


def _gard_attrs(model, state):
    return {"k_": np.full(state.y_train.shape[0], model.k_)}


def _pure_analog_predict(model, state, index_fit, X, index):
    k, kind = model._k_kind()
    C, m = X.shape[0], X.shape[1]
    if kind == "sample_analogs":
        # a fresh generator per call, as the JAX entry: every chunk draws
        # the same leading numbers, and a shard its rows of its pass's draw
        off, n = _pass_of(C)
        rand = np.random.default_rng(model.random_state).integers(0, k, (n, m))[off:off + C]
    else:
        rand = np.zeros((C, m))
    rand = torch.as_tensor(rand.astype(np.int32), device=X.device)
    return _gard.pure_analog_predict_batched(
        state.X_train, state.y_train, X, rand, k=k, kind=kind, thresh=model.thresh
    )


register(_gard.PureAnalog, _Impl(_gard_fit, _pure_analog_predict, None, _gard_attrs))


def _analog_reg_predict(model, state, index_fit, X, index):
    return _gard.analog_regression_predict_batched(
        state.X_train, state.y_train, X, k=model.k_, thresh=model.thresh
    )


register(_gard.AnalogRegression, _Impl(_gard_fit, _analog_reg_predict, None, _gard_attrs))


def _pure_reg_fit(model, index_fit, X, y):
    return _gard.pure_regression_fit(X, y, thresh=model.thresh)


def _pure_reg_predict(model, state, index_fit, X, index):
    return _gard.pure_regression_predict(state, X)


register(
    _gard.PureRegression,
    _Impl(
        _pure_reg_fit,
        _pure_reg_predict,
        None,
        lambda model, state: {"fit_error_": state.fit_error.cpu().numpy()},
    ),
)
