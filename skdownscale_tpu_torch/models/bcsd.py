"""BCSD bias correction, monthly dense path.

Port of the monthly part of ``skdownscale_tpu/models/bcsd.py``.  The
reference keeps a Python dict of per-group ``QuantileMapper`` objects and
loops pandas groupbys; here a BCSD fit or predict is one batched program
over padded group tables (see :mod:`.grouped`) with an explicit leading
cell axis.  Group membership, counts, tail windows and label lookups are
host tables, uploaded once per (plan, device).

Grouping semantics (monthly timestep, ``MONTH_GROUPER``): fit, transform
and climatology all partition by calendar month (``bcsd.py:46-57``); the
9-point centered climate-trend rolling mean (``bcsd.py:246-250``) runs
within the ``climate_trend`` groups.

Not ported yet, each raising ``NotImplementedError``:
``time_grouper="daily_nasa-nex"`` (ROADMAP.md Queue 1 item 6, needs the
slide kernel K5 and the streaming path) and ``quantile_mappers_``
(ROADMAP.md Queue 1 item 7, needs ``models/quantile.py``).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops.rolling import (
    rolling_mean_grouped_flat,
    rolling_mean_grouped_matmul,
    use_rolling_matmul,
)
from ..utils.timeindex import PaddedGroups, TimeIndex
from .base import SingleCellEstimator, asarray_2d
from .grouped import (
    GroupedCdf,
    gather_groups,
    grouped_qm_fit,
    grouped_qm_transform,
    scatter_groups,
)

__all__ = [
    "BcsdTemperature",
    "BcsdPrecipitation",
    "BcsdState",
    "bcsd_fit",
    "bcsd_predict",
    "MONTH_GROUPER",
    "DAY_GROUPER",
]

_DAILY_TODO = (
    "time_grouper='daily_nasa-nex' is not ported to PyTorch yet (ROADMAP.md "
    "Queue 1 item 6: daily BCSD, the slide kernel K5 and the streaming path); "
    "the JAX package runs it"
)
_MAPPERS_TODO = (
    "quantile_mappers_ is not ported to PyTorch yet (ROADMAP.md Queue 1 item 7: "
    "models/quantile.py); the fitted CDFs are in the estimator's state"
)


# ----------------------------------------------------------------------
# host-side grouping resolution
# ----------------------------------------------------------------------


def _pandas_partition(index, grouper) -> PaddedGroups:
    """Partition a time axis with any pandas-compatible grouper (callable,
    ``pd.Grouper``, ...) by running the groupby on host, mirroring
    ``df.groupby(self.time_grouper)`` (``bcsd.py:49``).

    A ``TimeIndex`` (non-pandas climate calendars) is partitioned directly:
    callable groupers are applied to the TimeIndex itself, and month-resample
    strings ('M'/'MS'/'ME') group by calendar month.
    """
    if isinstance(index, TimeIndex):
        if callable(grouper):
            vals = np.asarray(grouper(index))
        elif isinstance(grouper, str) and grouper in ("M", "MS", "ME"):
            vals = np.asarray(index.month)
        else:
            raise TypeError(
                f"grouper {grouper!r} requires a pandas DatetimeIndex; with a "
                "TimeIndex use a callable (e.g. MONTH_GROUPER) or 'M'"
            )
        keys, labels = np.unique(vals, return_inverse=True)
        return PaddedGroups.from_labels(labels.astype(np.int32), keys)
    import pandas as pd

    s = pd.Series(np.arange(len(index)), index=index)
    labels = np.empty(len(index), dtype=np.int32)
    keys = []
    for i, (key, grp) in enumerate(s.groupby(grouper)):
        labels[grp.to_numpy()] = i
        keys.append(key)
    return PaddedGroups.from_labels(labels, np.asarray(keys))


class _PredictPlan(NamedTuple):
    """Host-side group structure for one (fit index, predict index) pair."""

    fit: PaddedGroups
    transform: PaddedGroups  # partition of the predict axis
    rolling: PaddedGroups  # partition of the predict axis (climate_trend)
    transform_to_fit: np.ndarray  # (Gt,) fit-row for each transform group
    shift_labels: np.ndarray  # (Tp,) fit-row per predict step (x-climo lookup)
    anom_labels: np.ndarray  # (Tp,) fit-row per predict step (y-climo lookup)

    def __hash__(self):
        return hash(
            (
                self.fit,
                self.transform,
                self.rolling,
                self.transform_to_fit.tobytes(),
                self.shift_labels.tobytes(),
                self.anom_labels.tobytes(),
            )
        )

    def __eq__(self, other):
        if not isinstance(other, _PredictPlan):
            return NotImplemented
        return hash(self) == hash(other)


def _match_keys(src_keys, dst_keys, what: str) -> np.ndarray:
    lookup = {k: i for i, k in enumerate(np.asarray(dst_keys).tolist())}
    try:
        return np.array([lookup[k] for k in np.asarray(src_keys).tolist()], dtype=np.int32)
    except KeyError as e:  # a predict group with no fitted mapper
        raise KeyError(f"no fitted quantile mapper for {what} group {e}") from None


@functools.lru_cache(maxsize=64)
def _plan_tables(plan: _PredictPlan, device: torch.device):
    """Device index tensors of a predict plan: the fit-row columns aligned
    to the transform partition, and the climatology lookups."""
    G, L = plan.fit.indices.shape
    t2f = plan.transform_to_fit
    aligned_cols = (t2f[:, None] * L + np.arange(L)).reshape(-1)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long).to(device)

    return {
        "aligned_cols": i(aligned_cols),
        "t2f": i(t2f),
        "shift_labels": i(plan.shift_labels),
        "anom_labels": i(plan.anom_labels),
    }


# ----------------------------------------------------------------------
# functional core (batch-native: tensors are (..., T))
# ----------------------------------------------------------------------


class BcsdState(NamedTuple):
    """Fitted BCSD state in the flat 2-D layout of the JAX package's
    ``BcsdState`` (same fields, same order)."""

    pp: torch.Tensor  # (G*L,) plotting positions (shared across cells)
    vals: torch.Tensor  # (..., G*L) sorted per-group CDF values, flat
    aux: torch.Tensor  # (..., 4*G): [trend_slope, trend_intercept, y_climo, x_climo]

    def unpack(self, G: int, L: int):
        a = self.aux.reshape(*self.aux.shape[:-1], 4, G)
        qm = GroupedCdf(self.pp, self.vals, a[..., 0, :], a[..., 1, :])
        return qm, a[..., 2, :], a[..., 3, :]  # qm, y_climo, x_climo


@functools.lru_cache(maxsize=64)
def _group_count_denom(groups: PaddedGroups, device: torch.device, dtype: torch.dtype):
    return torch.as_tensor(np.maximum(groups.counts, 1), dtype=dtype).to(device)


def _masked_group_mean(v, groups: PaddedGroups):
    G, L = groups.indices.shape
    g = gather_groups(v, groups, fill=0.0)  # (..., G*L)
    denom = _group_count_denom(groups, v.device, v.dtype)
    return g.reshape(*g.shape[:-1], G, L).sum(dim=-1) / denom


def bcsd_fit(
    x,
    y,
    fit_groups: PaddedGroups,
    *,
    with_x_climo: bool = True,
    alpha: float = 0.4,
    beta: float = 0.4,
    detrend: bool = False,
) -> BcsdState:
    """``BcsdTemperature.fit`` / ``BcsdPrecipitation.fit`` core
    (``bcsd.py:115-147``, ``197-228``): per-group climatologies + per-group
    quantile-mapper CDFs of the target.  ``x``/``y``: (..., T)."""
    y_climo = _masked_group_mean(y, fit_groups)
    if with_x_climo:
        x_climo = _masked_group_mean(x, fit_groups)
    else:
        x_climo = torch.zeros_like(y_climo)
    qm = grouped_qm_fit(y, fit_groups, alpha=alpha, beta=beta, detrend=detrend)
    lead = y_climo.shape[:-1]
    G = fit_groups.n_groups
    aux = torch.stack([qm.trend_slope, qm.trend_intercept, y_climo, x_climo], dim=-2)
    return BcsdState(qm.pp, qm.vals, aux.reshape(*lead, 4 * G))


def _climate_trend_rolled(x, plan: _PredictPlan, rolling_window: int, n: int):
    """The 9-point centered climate-trend rolling mean (``bcsd.py:246-250``),
    group-bounded by ``plan.rolling``: one float32 GEMM with the host-built
    ``(n, n)`` matrix on the card, the flat windowed sum elsewhere (see
    :mod:`..ops.rolling` for why the CPU keeps the flat form)."""
    if use_rolling_matmul(x):
        rolled = rolling_mean_grouped_matmul(x, plan.rolling, rolling_window)
        if rolled is not None:
            return rolled
    xg = gather_groups(x, plan.rolling, fill=0.0)  # (..., M*Lr)
    rolled_flat = rolling_mean_grouped_flat(xg, rolling_window, plan.rolling.mask, min_periods=1)
    return scatter_groups(rolled_flat, plan.rolling, n)


def bcsd_predict(
    state: BcsdState,
    x,
    plan: _PredictPlan,
    *,
    variable: str = "temperature",
    return_anoms: bool = True,
    alpha: float = 0.4,
    beta: float = 0.4,
    extrapolate="both",
    n_endpoints: int = 10,
    detrend: bool = False,
    rolling_window: int = 9,
):
    """``BcsdTemperature.predict`` (``bcsd.py:230-269``) /
    ``BcsdPrecipitation.predict`` (``bcsd.py:149-170``) core.  ``x``: (..., T).
    """
    n = x.shape[-1]
    t2f = plan.transform_to_fit
    G, L = plan.fit.indices.shape
    qm, y_climo, x_climo = state.unpack(G, L)
    pt = _plan_tables(plan, x.device)
    # align fit-group CDFs/metadata to the transform partition's rows
    cols = pt["aligned_cols"]
    qm_aligned = GroupedCdf(
        qm.pp.index_select(-1, cols),
        qm.vals.index_select(-1, cols),
        qm.trend_slope.index_select(-1, pt["t2f"]),
        qm.trend_intercept.index_select(-1, pt["t2f"]),
    )
    fit_counts_aligned = plan.fit.counts[t2f]
    fit_valid_aligned = plan.fit.mask[t2f].reshape(-1)

    if variable == "temperature":
        # 9-point centered rolling mean within each climate-trend group
        rolled = _climate_trend_rolled(x, plan, rolling_window, n)
        # remove climatology from the climate trend (bcsd.py:253)
        x_shift = rolled - x_climo.index_select(-1, pt["shift_labels"])
        x_no_shift = x - x_shift
    else:
        x_shift = torch.zeros_like(x)
        x_no_shift = x

    xqm = grouped_qm_transform(
        qm_aligned,
        fit_counts_aligned,
        fit_valid_aligned,
        x_no_shift,
        plan.transform,
        alpha=alpha,
        beta=beta,
        extrapolate=extrapolate,
        n_endpoints=n_endpoints,
        detrend=detrend,
    )

    out = x_shift + xqm if variable == "temperature" else xqm  # restore the trend (bcsd.py:263)
    if return_anoms:
        y_climo_t = y_climo.index_select(-1, pt["anom_labels"])
        if variable == "temperature":
            out = out - y_climo_t
        else:
            out = out / y_climo_t  # ratio anomalies (bcsd.py:172-185)
    return out


# ----------------------------------------------------------------------
# sklearn-compatible wrappers
# ----------------------------------------------------------------------


def MONTH_GROUPER(x):
    """``groupers.py:11-12``."""
    return x.month


def DAY_GROUPER(x):
    """``groupers.py:15-16``."""
    return x.day


class BcsdBase(SingleCellEstimator):
    """Shared plumbing for the BCSD wrappers (API of ``bcsd.py:14-93``).

    The constructor takes the JAX package's parameters.  The single-cell
    ``fit``/``predict`` run on :attr:`single_cell_device` (the CPU, in
    float64); grids go through
    :class:`~skdownscale_tpu_torch.pointwise.PointWiseDownscaler`, which takes
    the device explicitly.
    """

    #: device of the single-cell API; a grid's device is the runner's
    single_cell_device = torch.device("cpu")

    _fit_attributes = ["y_climo_"]
    _with_x_climo = True

    def __init__(
        self,
        time_grouper=MONTH_GROUPER,
        climate_trend_grouper=DAY_GROUPER,
        climate_trend=MONTH_GROUPER,
        return_anoms: bool = True,
        qm_kwargs: dict[str, Any] | None = None,
    ):
        self.time_grouper = time_grouper
        self.climate_trend_grouper = climate_trend_grouper
        self.climate_trend = climate_trend
        self.return_anoms = return_anoms
        self.qm_kwargs = qm_kwargs

    # -- config ---------------------------------------------------------
    def _check_timestep(self) -> None:
        if isinstance(self.time_grouper, str):
            if self.time_grouper == "daily_nasa-nex":
                raise NotImplementedError(_DAILY_TODO)
            raise ValueError(
                "string frequency time_groupers are not supported (the reference "
                "passes them uninterpreted to pandas.groupby, bcsd.py:49); use a "
                "callable or a pd.Grouper"
            )

    def _qm_params(self):
        kw = dict(self.qm_kwargs or {})
        qt = dict(kw.get("qt_kwargs") or {})
        return {
            "detrend": bool(kw.get("detrend", False)),
            "alpha": qt.get("alpha", 0.4),
            "beta": qt.get("beta", 0.4),
            "extrapolate": qt.get("extrapolate", "both"),
            "n_endpoints": qt.get("n_endpoints", 10),
        }

    @property
    def quantile_mappers_(self):
        raise NotImplementedError(_MAPPERS_TODO)

    # -- host-side group resolution ------------------------------------
    def _fit_groups(self, index) -> PaddedGroups:
        self._check_timestep()
        return _pandas_partition(index, self.time_grouper)

    def _predict_plan(self, fit_groups: PaddedGroups, index) -> _PredictPlan:
        self._check_timestep()
        transform = _pandas_partition(index, self.time_grouper)
        rolling = _pandas_partition(index, self.climate_trend)
        t_to_fit = _match_keys(transform.keys, fit_groups.keys, "transform")
        shift_labels = t_to_fit[transform.labels]
        return _PredictPlan(fit_groups, transform, rolling, t_to_fit, shift_labels, shift_labels)

    # -- API ------------------------------------------------------------
    def fit(self, X, y):
        X, y = self._validate_data(X, y)
        Xa, ya = asarray_2d(X), asarray_2d(y)
        if Xa.shape[1] != 1:
            raise ValueError(f"BCSD only supports 1 feature, found {Xa.shape[1]}")
        index = self._pandas_index(X, len(Xa))
        fg = self._fit_groups(index)
        p = self._qm_params()
        dev = self.single_cell_device
        state = bcsd_fit(
            torch.tensor(Xa[:, 0], device=dev),
            torch.tensor(ya[:, 0], device=dev),
            fg,
            with_x_climo=self._with_x_climo,
            alpha=p["alpha"],
            beta=p["beta"],
            detrend=p["detrend"],
        )
        G, L = fg.indices.shape
        _, y_climo, _ = state.unpack(G, L)
        y_climo = y_climo.cpu().numpy()
        if self._with_x_climo is False and self.return_anoms:
            if float(np.min(y_climo)) <= 0:
                raise ValueError("Invalid value in target climatology")  # bcsd.py:140-141
        self._state = state
        self._fit_groups_ = fg
        self._fit_index_ = index
        self.y_climo_ = y_climo
        return self

    def predict(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        Xa = asarray_2d(X)
        index = self._pandas_index(X, len(Xa))
        plan = self._predict_plan(self._fit_groups_, index)
        p = self._qm_params()
        out = bcsd_predict(
            self._state,
            torch.tensor(Xa[:, 0], device=self.single_cell_device),
            plan,
            variable="temperature" if self._with_x_climo else "precipitation",
            return_anoms=bool(self.return_anoms),
            **{k: p[k] for k in ("alpha", "beta", "extrapolate", "n_endpoints", "detrend")},
        ).cpu().numpy()
        if hasattr(X, "iloc"):
            import pandas as pd

            cols = list(X.columns) if hasattr(X, "columns") else [0]
            return pd.DataFrame(out.reshape(-1, 1), index=X.index, columns=cols)
        return out.reshape(-1, 1)

    def _pandas_index(self, X, n):
        import pandas as pd

        if hasattr(X, "index") and isinstance(X.index, pd.DatetimeIndex):
            return X.index
        import warnings

        warnings.warn("X does not have a pandas DateTimeIndex, making one up...")
        return pd.date_range(start="1950", periods=n, freq=self._timestep)


class BcsdTemperature(BcsdBase):
    """Classic BCSD for temperature (``bcsd.py:196-289``): quantile-map the
    9-year climate-trend-removed series, restore the trend, and optionally
    return anomalies vs the target climatology."""

    _with_x_climo = True


class BcsdPrecipitation(BcsdBase):
    """Classic BCSD for precipitation (``bcsd.py:96-193``): per-group quantile
    mapping followed by ratio anomalies vs a strictly-positive target
    climatology."""

    _with_x_climo = False
