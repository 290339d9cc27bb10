"""BCSD bias correction: dense and streaming paths, monthly and daily.

Port of ``skdownscale_tpu/models/bcsd.py``.  The reference keeps a Python
dict of per-group ``QuantileMapper`` objects and loops pandas groupbys;
here a BCSD fit or predict is one batched program over padded group tables
(see :mod:`.grouped`, :mod:`.streaming`) with an explicit leading cell
axis.  Group membership, counts, tail windows and label lookups are host
tables, uploaded once per (plan, device).

Grouping semantics preserved:

* monthly timestep (default ``MONTH_GROUPER``): fit, transform and
  climatology all partition by calendar month (``bcsd.py:46-57``);
* ``'daily_nasa-nex'``: fit groups are the +/-15-day padded day-of-year
  windows (``groupers.py:19-82``), while predict-time transform and
  climate-trend climatology removal group by day of month
  (``bcsd.py:51-53``, ``climate_trend_grouper=DAY_GROUPER``) and look those
  keys up in the day-of-year-keyed tables, as the reference does;
* daily with ``return_anoms=True`` raises: the reference's climatology
  removal concatenates overlapping day groups and fails its own shape check
  (``bcsd.py:90-92`` / ``181-183``).

The 9-point centered climate-trend rolling mean (``bcsd.py:246-250``) runs
within the ``climate_trend`` groups.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from ..kernels.slide_sort import slide_sorted_windows
from ..ops.rolling import (
    rolling_mean_grouped_flat,
    rolling_mean_grouped_matmul,
    rows_matmul,
    use_rolling_matmul,
)
from ..utils.timeindex import PaddedGroups, TimeIndex, padded_doy_groups
from .base import SingleCellEstimator, asarray_2d
from .grouped import (
    GroupedCdf,
    gather_groups,
    grouped_qm_fit,
    grouped_qm_transform,
    scatter_groups,
)
from .groupers import DAY_GROUPER, MONTH_GROUPER
from .slide import SlidePlan, build_slide_plan, consulted_groups
from .streaming import stream_tables_on, streaming_qm_transform

__all__ = [
    "BcsdTemperature",
    "BcsdPrecipitation",
    "BcsdState",
    "bcsd_fit",
    "bcsd_predict",
    "BcsdLazyState",
    "bcsd_fit_lazy",
    "bcsd_predict_streaming",
    "MONTH_GROUPER",
    "DAY_GROUPER",
]

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

    fit: PaddedGroups  # possibly overlapping (daily flavor)
    transform: PaddedGroups  # partition of the predict axis
    rolling: PaddedGroups  # partition of the predict axis (climate_trend)
    transform_to_fit: np.ndarray  # (Gt,) fit-row for each transform group
    shift_labels: np.ndarray  # (Tp,) fit-row per predict step (x-climo lookup)
    anom_labels: np.ndarray | None  # (Tp,) fit-row per predict step, None -> raise
    slide: SlidePlan | None = None  # daily sliding-window plan (K5)

    def __hash__(self):
        return hash(
            (
                self.fit,
                self.transform,
                self.rolling,
                self.transform_to_fit.tobytes(),
                self.shift_labels.tobytes(),
                None if self.anom_labels is None else self.anom_labels.tobytes(),
                self.slide,
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
    to the transform partition, and the climatology lookups (``anom_labels``
    falls back to ``shift_labels``, as in the JAX package)."""
    G, L = plan.fit.indices.shape
    t2f = plan.transform_to_fit
    aligned_cols = (t2f[:, None] * L + np.arange(L)).reshape(-1)
    anom = plan.anom_labels if plan.anom_labels is not None else plan.shift_labels

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long).to(device)

    return {
        "aligned_cols": i(aligned_cols),
        "t2f": i(t2f),
        "shift_labels": i(plan.shift_labels),
        "anom_labels": i(anom),
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

    shared_fields = ("pp",)  # no cell axis (models/batched.py: split_cells)

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
# streaming (group-chunked) variant: the daily flavor at any cell count,
# the monthly flavor above STREAMING_CELL_THRESHOLD (models/batched.py)
# ----------------------------------------------------------------------


class BcsdLazyState(NamedTuple):
    """Deferred BCSD fit state: raw target series + per-group climatologies.

    The daily flavor's 366 overlapping +/-15-day windows expand the training
    series 27x, so the fit stores the raw series and predict computes only
    the fit rows its transform partition consults (31 of 366 in the daily
    flavor), chunk by chunk.
    """

    y: torch.Tensor  # (..., T_fit) raw target series
    aux: torch.Tensor  # (..., 2*G): [y_climo, x_climo]

    def unpack(self, G: int):
        a = self.aux.reshape(*self.aux.shape[:-1], 2, G)
        return a[..., 0, :], a[..., 1, :]  # y_climo, x_climo


def _membership_matrix(groups: PaddedGroups, n: int, dtype=np.float64) -> np.ndarray:
    """Host (n, G) mean-pooling matrix: column g averages group g's members
    (column sums to 1; overlapping groups allowed)."""
    G, L = groups.indices.shape
    M = np.zeros((n, G), dtype)
    inv = 1.0 / np.maximum(groups.counts, 1)
    for g in range(G):
        np.add.at(M[:, g], groups.indices[g][groups.mask[g]], inv[g])
    return M


@functools.lru_cache(maxsize=16)
def _membership_dev(groups: PaddedGroups, n: int, device: torch.device, dtype: torch.dtype):
    return torch.as_tensor(_membership_matrix(groups, n), dtype=dtype).to(device)


def bcsd_fit_lazy(x, y, fit_groups: PaddedGroups, *, with_x_climo: bool = True) -> BcsdLazyState:
    """Deferred-CDF BCSD fit: only the per-group climatologies
    (``bcsd.py:219-223``), as two ``(C, T) @ (T, G)`` mean-pooling products
    in full float32 or float64 (TF32 is off, as the JAX package ran them at
    ``Precision.HIGHEST``), with the raw target carried as state."""
    M = _membership_dev(fit_groups, y.shape[-1], y.device, y.dtype)
    y_climo = rows_matmul(y, M)
    x_climo = rows_matmul(x, M) if with_x_climo else torch.zeros_like(y_climo)
    aux = torch.stack([y_climo, x_climo], dim=-2)
    return BcsdLazyState(y, aux.reshape(*y_climo.shape[:-1], -1))


def _slide_n_rows(plan: _PredictPlan, group_chunk: int) -> int:
    """Slide output rows padded to the chunk grid (NC*Gc transform groups),
    so chunk ``c`` reads windows ``[c*Gc, (c+1)*Gc)`` as one slice of the
    flat slide output."""
    Gt = plan.transform.indices.shape[0]
    Gc = min(group_chunk, Gt)
    return -(-Gt // Gc) * Gc


def bcsd_predict_streaming(
    state,
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
    group_chunk: int = 8,
):
    """``bcsd_predict`` with the grouped QM transform run as a loop over
    transform-group chunks (see :mod:`.streaming`).  Takes a dense
    :class:`BcsdState` (presorted group CDFs) or a :class:`BcsdLazyState`.

    With a lazy state and a slide plan (daily, ``detrend=False``) the
    consulted windows' sorted values come from the slide kernel K5 and the
    chunks read them as presorted slices; otherwise each chunk gathers its
    raw windows and sorts them (K1 up to 256 members).  The slide route is
    taken on every device, so a NaN inside a fit window follows K5's rule
    everywhere (see :mod:`..kernels.slide_sort`)."""
    n = x.shape[-1]
    G, L = plan.fit.indices.shape
    fit_tab, t2f_tab = plan.fit, plan.transform_to_fit
    if isinstance(state, BcsdLazyState):
        y_climo, x_climo = state.unpack(G)
        source, presorted, state_trend = state.y, False, None
        if plan.slide is not None and not detrend:
            svals = slide_sorted_windows(state.y, plan.slide, n_rows=_slide_n_rows(plan, group_chunk))
            source, presorted = svals.to(x.dtype), True
            fit_tab = consulted_groups(plan.fit, plan.slide)
            t2f_tab = np.searchsorted(plan.slide.consulted, plan.transform_to_fit).astype(np.int32)
    else:
        qm, y_climo, x_climo = state.unpack(G, L)
        source, presorted = qm.vals, True
        state_trend = (qm.trend_slope, qm.trend_intercept)

    pt = _plan_tables(plan, x.device)
    if variable == "temperature":
        rolled = _climate_trend_rolled(x, plan, rolling_window, n)
        x_shift = rolled - x_climo.index_select(-1, pt["shift_labels"])
        x_no_shift = x - x_shift
    else:
        x_no_shift = x

    tables = stream_tables_on(
        fit_tab,
        plan.transform,
        np.ascontiguousarray(t2f_tab, dtype=np.int32).tobytes(),
        n,
        alpha,
        beta,
        n_endpoints,
        group_chunk,
        "state" if presorted else "raw",
        x.device,
        x.dtype,
    )
    # fold the additive terms (restore the climate trend, remove the target
    # climatology) into the chunk loop's output carry
    out_init = None
    if variable == "temperature":
        out_init = x_shift
        if return_anoms:
            out_init = out_init - y_climo.index_select(-1, pt["anom_labels"])
    out = streaming_qm_transform(
        source,
        x_no_shift,
        tables,
        presorted=presorted,
        extrapolate=extrapolate,
        detrend=detrend,
        state_trend=state_trend,
        out_init=out_init,
    )
    if variable != "temperature" and return_anoms:
        out = out / y_climo.index_select(-1, pt["anom_labels"])  # ratio anomalies (bcsd.py:172-185)
    return out


# ----------------------------------------------------------------------
# sklearn-compatible wrappers
# ----------------------------------------------------------------------


class BcsdBase(SingleCellEstimator):
    """Shared plumbing for the BCSD wrappers (API of ``bcsd.py:14-93``).

    The constructor takes the JAX package's parameters.  The single-cell
    ``fit``/``predict`` run on ``single_cell_device`` (see
    :class:`~.base.SingleCellEstimator`: the card unless the caller asks for
    the CPU); grids go through
    :class:`~skdownscale_tpu_torch.pointwise.PointWiseDownscaler`, which takes
    the device explicitly.
    """

    _fit_attributes = ["y_climo_", "quantile_mappers_"]
    _timestep = "MS"  # frequency of the index made up for input without one
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
    @property
    def _timestep_kind(self) -> str:
        if isinstance(self.time_grouper, str):
            if self.time_grouper == "daily_nasa-nex":
                return "daily"
            raise ValueError(
                "string frequency time_groupers are not supported (the reference "
                "passes them uninterpreted to pandas.groupby, bcsd.py:49); use a "
                "callable, a pd.Grouper, or 'daily_nasa-nex'"
            )
        return "monthly"

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

    # -- host-side group resolution ------------------------------------
    def _fit_groups(self, index) -> PaddedGroups:
        if self._timestep_kind == "daily":
            return padded_doy_groups(TimeIndex.from_any(index), offset=15)
        return _pandas_partition(index, self.time_grouper)

    def _predict_plan(self, fit_groups: PaddedGroups, index) -> _PredictPlan:
        daily = self._timestep_kind == "daily"
        transform = _pandas_partition(
            index, self.climate_trend_grouper if daily else self.time_grouper
        )
        rolling = _pandas_partition(index, self.climate_trend)
        t_to_fit = _match_keys(transform.keys, fit_groups.keys, "transform")
        shift_labels = t_to_fit[transform.labels]
        if daily:  # the reference raises on overlapping-group climatology
            return _PredictPlan(
                fit_groups, transform, rolling, t_to_fit, shift_labels, None,
                build_slide_plan(fit_groups, t_to_fit),
            )
        return _PredictPlan(fit_groups, transform, rolling, t_to_fit, shift_labels, shift_labels)

    def _check_anoms(self, plan: _PredictPlan) -> None:
        if self.return_anoms and plan.anom_labels is None:
            raise ValueError(
                "Result shape does not match input shape (daily BCSD with "
                "return_anoms=True replicates the reference's overlapping-group "
                "climatology failure, bcsd.py:90-92)"
            )

    # -- API ------------------------------------------------------------
    def fit(self, X, y):
        X, y = self._validate_data(X, y)
        Xa, ya = asarray_2d(X), asarray_2d(y)
        if Xa.shape[1] != 1:
            raise ValueError(f"BCSD only supports 1 feature, found {Xa.shape[1]}")
        index = self._pandas_index(X, len(Xa))
        fg = self._fit_groups(index)
        p = self._qm_params()
        state = bcsd_fit(
            self._cell_tensor(Xa[:, 0]),
            self._cell_tensor(ya[:, 0]),
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
        # per-group mappers (reference: dict of fitted QuantileMapper
        # objects, bcsd.py:59-67), holding copies of the fitted CDFs
        from ..ops.cdf import Cdf
        from .quantile import CunnaneTransformer, QuantileMapper

        self.quantile_mappers_ = {}
        vals2 = state.vals.cpu().numpy().reshape(G, L)
        pp2 = state.pp.cpu().numpy().reshape(G, L)
        for g, key in enumerate(np.asarray(fg.keys).tolist()):
            c = int(fg.counts[g])
            mapper = QuantileMapper(**dict(self.qm_kwargs or {}))
            qt = CunnaneTransformer(
                alpha=p["alpha"], beta=p["beta"],
                extrapolate=p["extrapolate"], n_endpoints=p["n_endpoints"],
            )
            qt.cdf_ = Cdf(pp2[g, :c].copy(), vals2[g, :c].copy())
            mapper.x_cdf_fit_ = qt
            mapper._state = None  # CDF copies only; fitted by the batched core
            self.quantile_mappers_[key] = mapper
        return self

    def predict(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        Xa = asarray_2d(X)
        index = self._pandas_index(X, len(Xa))
        plan = self._predict_plan(self._fit_groups_, index)
        self._check_anoms(plan)
        p = self._qm_params()
        out = bcsd_predict(
            self._state,
            self._cell_tensor(Xa[:, 0]),
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
