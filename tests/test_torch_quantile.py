"""The port's quantile-mapping family against the JAX package on the CPU,
in float64: the cores of ``models/quantile.py`` and ``models/trend.py``
(the interps run the plain K6, ``qm_transform`` the plain K2), the
sklearn wrappers, ``ops/cdf.py``, fitted state carried across packages by
``convert.py``, and ``PointWiseDownscaler`` fit / predict / transform /
inverse_transform end to end.

Tolerance: ``atol = 1e-10`` on values of order 300 (the same float64
arithmetic in another order: sums over a series, the closed forms of
interp and OLS), with ``rtol = 1e-14`` for the synthetic CDF endpoints,
whose values are near 1e22 (a few ulp); NaN at the same places.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import skdownscale_tpu as J
import skdownscale_tpu.models.quantile as jq
import skdownscale_tpu.models.trend as jt
import skdownscale_tpu.ops.cdf as jcdf
from skdownscale_tpu.xlite import DataArray as JDA

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.models.quantile as pq
import skdownscale_tpu_torch.models.trend as pt
import skdownscale_tpu_torch.ops.cdf as pcdf
from skdownscale_tpu_torch.convert import (
    qm_state_from_jax,
    qm_state_to_numpy,
    qmr_state_from_jax,
    qmr_state_to_numpy,
    trend_state_from_jax,
)
from skdownscale_tpu_torch.models.base import SingleCellEstimator
from skdownscale_tpu_torch.xlite import DataArray as PDA

ATOL, RTOL = 1e-10, 1e-14
EXTRAPOLATE = [None, "1to1", "min", "max", "both"]


@pytest.fixture(autouse=True)
def single_cell_on_cpu(monkeypatch):
    """The single-cell API runs on the card by default; these tests ask for
    the CPU (float64)."""
    monkeypatch.setattr(SingleCellEstimator, "single_cell_device", torch.device("cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _series(rng, C, n, loc=283.0, shift=0.0, trend=0.01, quantize=False):
    t = np.arange(n)
    seas = 10 * np.sin(2 * np.pi * t / 365.25)
    x = loc + shift + seas + rng.normal(0, 2, (C, n)) + trend * t
    return np.round(x) if quantize else x


# ----------------------------------------------------------------------
# ops/cdf.py, models/trend.py
# ----------------------------------------------------------------------


@pytest.mark.parametrize("extrapolate", EXTRAPOLATE)
@pytest.mark.parametrize("n_endpoints", [10, 3])
def test_calc_extrapolated_cdf_matches_jax(rng, extrapolate, n_endpoints):
    x = _series(rng, 5, 80)
    got = pcdf.calc_extrapolated_cdf(_t(x), extrapolate=extrapolate, n_endpoints=n_endpoints)
    want = jcdf.calc_extrapolated_cdf(jnp.asarray(x), extrapolate=extrapolate, n_endpoints=n_endpoints)
    npt.assert_array_equal(got.pp.numpy(), np.asarray(want.pp))
    assert got.pp.stride()[0] == 0  # one plotting-position vector, expanded
    _same(got.vals, want.vals)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        npt.assert_array_equal(
            pcdf.plotting_positions(37, dtype=dtype).numpy(),
            np.asarray(jcdf.plotting_positions(37, dtype=jdtype)),
        )
    with pytest.raises(ValueError, match="unknown value"):
        pcdf.calc_extrapolated_cdf(_t(x), extrapolate="sideways")


@pytest.mark.parametrize("lr_kwargs", [None, {"fit_intercept": False}, {"positive": True},
                                       {"fit_intercept": False, "positive": True}])
def test_linear_trend_matches_jax(rng, lr_kwargs):
    x = _series(rng, 1, 300, trend=-0.02).T  # a falling trend: positive clamps it
    x = np.concatenate([x, _series(rng, 1, 300, trend=0.03).T], axis=1)  # two features
    j = jt.LinearTrendTransformer(lr_kwargs=lr_kwargs).fit(x)
    p = pt.LinearTrendTransformer(lr_kwargs=lr_kwargs).fit(x)
    _same(p.lr_model_.coef_, j.lr_model_.coef_)
    _same(p.lr_model_.intercept_, j.lr_model_.intercept_)
    _same(p.trendline(x), j.trendline(x))
    _same(p.transform(x), np.asarray(j.transform(x)))
    _same(p.inverse_transform(x), np.asarray(j.inverse_transform(x)))
    _same(p.fit_transform(x), np.asarray(j.fit_transform(x)))
    _same(p.lr_model_.predict(np.arange(5)), j.lr_model_.predict(np.arange(5)))
    assert not hasattr(p, "score")
    # the functional cores on a batch
    xb = _series(rng, 4, 120, trend=-0.01)
    fi = (lr_kwargs or {}).get("fit_intercept", True)
    pos = (lr_kwargs or {}).get("positive", False)
    ps, js = pt.trend_fit_opts(_t(xb), fi, pos), jt.trend_fit_opts(jnp.asarray(xb), fi, pos)
    _same(ps.slope, js.slope)
    _same(pt.trend_transform(ps, _t(xb)), jt.trend_transform(js, jnp.asarray(xb)))
    _same(pt.trend_inverse(ps, _t(xb)), jt.trend_inverse(js, jnp.asarray(xb)))
    with pytest.raises(ValueError, match="unsupported lr_kwargs"):
        pt.LinearTrendTransformer(lr_kwargs={"tol": 1}).fit(x)


# ----------------------------------------------------------------------
# cores
# ----------------------------------------------------------------------


@pytest.mark.parametrize("extrapolate", EXTRAPOLATE)
def test_cunnane_cores_match_jax(rng, extrapolate):
    x = _series(rng, 6, 150)
    xq = _series(rng, 6, 70, shift=1.5, quantize=True)  # ties and values beyond both ends
    xq[:, 0], xq[:, 1] = x.min(axis=1) - 5, x.max(axis=1) + 5
    q = np.linspace(-0.1, 1.1, 61)[None].repeat(6, 0)
    pcd, jcd = pq.cunnane_fit(_t(x), 0.4, 0.4), jq.cunnane_fit(jnp.asarray(x), 0.4, 0.4)
    npt.assert_array_equal(pcd.vals.numpy(), np.asarray(jcd.vals))
    npt.assert_array_equal(pcd.pp.numpy(), np.asarray(jcd.pp))
    _same(pq.cunnane_transform(pcd, _t(xq), extrapolate), jq.cunnane_transform(jcd, jnp.asarray(xq), extrapolate))
    _same(pq.cunnane_inverse(pcd, _t(q), extrapolate), jq.cunnane_inverse(jcd, jnp.asarray(q), extrapolate))


@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("n_fit,n", [(120, 90), (90, 120), (100, 100)])
@pytest.mark.parametrize("extrapolate", ["both", None, "max"])
def test_qm_cores_match_jax(rng, detrend, n_fit, n, extrapolate):
    x = _series(rng, 5, n_fit, quantize=detrend)  # ties in one flavor
    xq = _series(rng, 5, n, shift=1.0, trend=0.03)
    xq[1, 7] = np.nan
    ps = pq.qm_fit(_t(x), detrend=detrend)
    js = jq.qm_fit(jnp.asarray(x), detrend=detrend)
    for a, b in zip(ps, js):
        _same(a, b)
    kw = dict(detrend=detrend, extrapolate=extrapolate)
    _same(pq.qm_transform(ps, _t(xq), **kw), jq.qm_transform(js, jnp.asarray(xq), **kw))


def _qmr_data(rng, nx, ny, nq, C=4):
    x = _series(rng, C, nx)
    y = _series(rng, C, ny, loc=281.0)
    xq = _series(rng, C, nq, shift=2.0, trend=0.02)
    xq[:, 0], xq[:, 1] = x.min(axis=1) - 4, x.max(axis=1) + 4  # beyond the fit range
    return x, y, xq


@pytest.mark.parametrize("extrapolate", EXTRAPOLATE)
@pytest.mark.parametrize("lengths", [(200, 200, 150), (240, 180, 150), (180, 240, 300)])
def test_qmr_cores_match_jax(rng, extrapolate, lengths):
    """Every extrapolate mode; with ``'1to1'`` the three branches of
    ``_extrapolate_1to1`` (equal lengths, X longer, y longer)."""
    x, y, xq = _qmr_data(rng, *lengths)
    kw = dict(extrapolate=extrapolate, n_endpoints=10)
    ps, js = pq.qmr_fit(_t(x), _t(y), **kw), jq.qmr_fit(jnp.asarray(x), jnp.asarray(y), **kw)
    for a, b in zip(ps, js):
        _same(a, b)
    _same(pq.qmr_predict(ps, _t(xq), **kw), jq.qmr_predict(js, jnp.asarray(xq), **kw))


@pytest.mark.parametrize("kind,max_ratio", [("difference", None), ("ratio", None), ("ratio", 1.001)])
@pytest.mark.parametrize("nq", [200, 130])
@pytest.mark.parametrize("extrapolate", [None, "both", "1to1"])
def test_edcdfm_matches_jax(rng, kind, max_ratio, nq, extrapolate):
    """Equal fit/predict lengths take the identity branch, unequal the
    host rank-bracket tables; ``y`` of another length too."""
    x, y, xq = _qmr_data(rng, 200, 200 if nq == 200 else 170, nq)
    kw = dict(extrapolate=extrapolate, n_endpoints=10)
    ps, js = pq.qmr_fit(_t(x), _t(y), **kw), jq.qmr_fit(jnp.asarray(x), jnp.asarray(y), **kw)
    kw.update(kind=kind, max_ratio=max_ratio)
    _same(pq.edcdfm_predict(ps, _t(xq), **kw), jq.edcdfm_predict(js, jnp.asarray(xq), **kw))


def test_edcdfm_identity_branch_needs_equal_pp_dtypes(rng):
    """The identity branch is chosen by shape and dtype; both give the same
    values here, so a float32 pp state must still match."""
    x, y, xq = _qmr_data(rng, 150, 150, 150)
    ps = pq.qmr_fit(_t(x), _t(y), extrapolate="both")
    got = pq.edcdfm_predict(ps, _t(xq), extrapolate="both")
    mixed = pq.QmrState(ps.x_pp.float(), ps.x_vals, ps.y_pp.float(), ps.y_vals)
    _same(pq.edcdfm_predict(mixed, _t(xq), extrapolate="both"), got, atol=1e-6)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------


def _frame(a, start="1990-01-01"):
    return pd.DataFrame({"t": a}, index=pd.date_range(start, periods=len(a), freq="D"))


@pytest.mark.parametrize("extrapolate", [None, "both", "min", "max"])
def test_cunnane_wrapper_matches_jax(rng, extrapolate):
    x = _series(rng, 1, 300, trend=0)[0].reshape(-1, 1)
    xq = _series(rng, 1, 120, shift=1, trend=0)[0].reshape(-1, 1)
    q = np.linspace(-0.1, 1.1, 50).reshape(-1, 1)
    j = J.CunnaneTransformer(extrapolate=extrapolate).fit(x)
    p = P.CunnaneTransformer(extrapolate=extrapolate).fit(x)
    assert p.get_params() == j.get_params()
    npt.assert_array_equal(p.cdf_.vals, j.cdf_.vals)
    _same(p.transform(xq), j.transform(xq))
    _same(p.inverse_transform(q), j.inverse_transform(q))
    _same(p.fit_transform(x), j.fit_transform(x))
    with pytest.raises(ValueError, match="single feature"):
        P.CunnaneTransformer().fit(np.ones((30, 2)))


@pytest.mark.parametrize("detrend", [False, True])
def test_quantile_mapper_wrapper_matches_jax(rng, detrend):
    x = _frame(_series(rng, 1, 400)[0])
    xq = _frame(_series(rng, 1, 250, shift=1.2)[0], start="2050-01-01")
    j = J.QuantileMapper(detrend=detrend).fit(x)
    p = P.QuantileMapper(detrend=detrend).fit(x)
    assert p.get_params() == j.get_params()
    _same(p.x_cdf_fit_.cdf_.vals, j.x_cdf_fit_.cdf_.vals)
    _same(p.transform(xq), j.transform(xq))
    _same(p.fit_transform(x), j.fit_transform(x))
    with pytest.raises(ValueError, match="only supports 1"):
        P.QuantileMapper().fit(np.ones((30, 2)))


@pytest.mark.parametrize("extrapolate", EXTRAPOLATE)
def test_qmr_and_edcdfm_wrappers_match_jax(rng, extrapolate):
    x = _series(rng, 1, 300)[0]
    y = _series(rng, 1, 240, loc=281)[0]  # lengths may differ
    xq = _series(rng, 1, 150, shift=2)[0]
    for cls, kw in (("QuantileMappingReressor", {}),
                    ("EquidistantCdfMatcher", {"kind": "difference"}),
                    ("EquidistantCdfMatcher", {"kind": "ratio", "max_ratio": 1.01})):
        j = getattr(J, cls)(extrapolate=extrapolate, **kw).fit(x.reshape(-1, 1), y)
        p = getattr(P, cls)(extrapolate=extrapolate, **kw).fit(x.reshape(-1, 1), y)
        assert p.get_params() == j.get_params()
        _same(p._X_cdf.vals, j._X_cdf.vals)
        _same(p.predict(xq.reshape(-1, 1)), j.predict(xq.reshape(-1, 1)))


def test_quantile_wrappers_validate_as_jax(rng):
    x = _series(rng, 1, 50)[0].reshape(-1, 1)
    for pkg in (J, P):
        with pytest.raises(ValueError, match="requires y"):
            pkg.QuantileMappingReressor().fit(x, None)
        with pytest.raises(ValueError, match="unknown value"):
            pkg.QuantileMappingReressor(extrapolate="x").fit(x, x)
        with pytest.raises(ValueError, match="contains NaN"):
            pkg.QuantileMappingReressor().fit(x, np.where(x > 290, np.nan, x))
        with pytest.raises(ValueError, match="n_endpoints"):
            pkg.QuantileMappingReressor(n_endpoints=1).fit(x, x)
        with pytest.raises(ValueError, match="minimum of 21"):
            pkg.QuantileMappingReressor().fit(x[:20], x[:20])
        with pytest.raises(NotImplementedError, match="kind"):
            pkg.EquidistantCdfMatcher(kind="sum").fit(x, x)
        with pytest.raises(Exception, match="not fitted"):
            pkg.QuantileMappingReressor().predict(x)


@pytest.mark.parametrize("inner", ["qmr", "edcdfm"])
@pytest.mark.parametrize("lr_kwargs", [None, {"fit_intercept": False}, {"positive": True}])
def test_trend_aware_wrapper_matches_jax(rng, inner, lr_kwargs):
    x = _frame(_series(rng, 1, 500, trend=0.02)[0])
    y = _frame(_series(rng, 1, 500, loc=281, trend=-0.01)[0])
    xq = _frame(_series(rng, 1, 300, shift=1.5, trend=0.03)[0], start="2050-01-01")

    def make(pkg):
        qm = (pkg.QuantileMappingReressor(extrapolate="both") if inner == "qmr"
              else pkg.EquidistantCdfMatcher(kind="difference", extrapolate="both"))
        return pkg.TrendAwareQuantileMappingRegressor(qm, pkg.LinearTrendTransformer(lr_kwargs))

    j, p = make(J).fit(x, y), make(P).fit(x, y)
    _same(p.predict(xq), j.predict(xq))


# ----------------------------------------------------------------------
# state across packages
# ----------------------------------------------------------------------


def test_fitted_state_carries_across_packages(rng):
    x, y, xq = _qmr_data(rng, 220, 180, 130)
    # QMR: JAX fit -> port predict, and port fit -> JAX predict
    js = jq.qmr_fit(jnp.asarray(x), jnp.asarray(y), extrapolate="both")
    ps = qmr_state_from_jax(*(np.asarray(a) for a in js))
    want = jq.qmr_predict(js, jnp.asarray(xq), extrapolate="both")
    _same(pq.qmr_predict(ps, _t(xq), extrapolate="both"), want)
    back = jq.QmrState(*(jnp.asarray(a) for a in qmr_state_to_numpy(pq.qmr_fit(_t(x), _t(y), extrapolate="both"))))
    _same(np.asarray(jq.qmr_predict(back, jnp.asarray(xq), extrapolate="both")), want)
    # QuantileMapper
    jm = jq.qm_fit(jnp.asarray(x), detrend=True)
    pm = qm_state_from_jax(*(np.asarray(a) for a in jm))
    want = jq.qm_transform(jm, jnp.asarray(xq), detrend=True)
    _same(pq.qm_transform(pm, _t(xq), detrend=True), want)
    back = jq.QmState(*(jnp.asarray(a) for a in qm_state_to_numpy(pq.qm_fit(_t(x), detrend=True))))
    _same(np.asarray(jq.qm_transform(back, jnp.asarray(xq), detrend=True)), want)
    # TrendState
    jtr = jt.trend_fit(jnp.asarray(x))
    _same(pt.trend_line(trend_state_from_jax(*(np.asarray(a) for a in jtr)), 40),
          jt.trend_line(jtr, 40))


# ----------------------------------------------------------------------
# the grid runner
# ----------------------------------------------------------------------


def _grids(rng, T_fit=240, T_pred=150, C=48):
    idx = pd.date_range("1990-01-01", periods=T_fit, freq="D")
    idx_p = pd.date_range("2050-01-01", periods=T_pred, freq="D")
    x = _series(rng, C, T_fit, trend=0.01).T
    y = _series(rng, C, T_fit, loc=281).T
    xq = _series(rng, C, T_pred, shift=1.5, trend=0.02).T
    for a in (x, y, xq):
        a[:, [0, 9, 30]] = np.nan  # NaN cells
    dims = ("time", "cell")
    return dims, {"time": idx, "cell": np.arange(C)}, {"time": idx_p, "cell": np.arange(C)}, x, y, xq


def _models(pkg):
    return {
        "qmr": lambda: pkg.QuantileMappingReressor(extrapolate="both"),
        "qmr_1to1": lambda: pkg.QuantileMappingReressor(extrapolate="1to1"),
        "edcdfm": lambda: pkg.EquidistantCdfMatcher(kind="difference", extrapolate="both"),
        "trend_aware_qmr": lambda: pkg.TrendAwareQuantileMappingRegressor(
            pkg.QuantileMappingReressor(extrapolate="both")
        ),
        "trend_aware_edcdfm": lambda: pkg.TrendAwareQuantileMappingRegressor(
            pkg.EquidistantCdfMatcher(kind="difference", extrapolate="both")
        ),
        "edcdfm_ratio": lambda: pkg.EquidistantCdfMatcher(kind="ratio", max_ratio=1.02),
    }


@pytest.mark.parametrize("name", sorted(_models(P)))
def test_pointwise_predict_matches_jax(rng, name):
    """Fit over 240 steps, predict over 150 (another length) and over the
    fit period, with NaN cells, in two cell chunks."""
    dims, c_fit, c_pred, x, y, xq = _grids(rng)
    j = J.PointWiseDownscaler(_models(J)[name]())
    j.fit(JDA(x, dims, c_fit), JDA(y, dims, c_fit))
    p = P.PointWiseDownscaler(_models(P)[name](), device="cpu", cell_chunk_size=30)
    p.fit(PDA(x, dims, c_fit), PDA(y, dims, c_fit))
    for q, c in ((xq, c_pred), (x, c_fit)):
        want = j.predict(JDA(q, dims, c)).values
        got = p.predict(PDA(q, dims, c))
        assert isinstance(got, PDA) and got.dims == dims and got.values.dtype == np.float64
        _same(got.values, want)


@pytest.mark.parametrize("name", ["cunnane", "quantile_mapper", "quantile_mapper_detrend", "trend"])
def test_pointwise_transform_matches_jax(rng, name):
    dims, c_fit, c_pred, x, _, xq = _grids(rng)
    make = {
        "cunnane": lambda pkg: pkg.CunnaneTransformer(extrapolate="both"),
        "quantile_mapper": lambda pkg: pkg.QuantileMapper(),
        "quantile_mapper_detrend": lambda pkg: pkg.QuantileMapper(detrend=True),
        "trend": lambda pkg: pkg.LinearTrendTransformer(),
    }[name]
    j = J.PointWiseDownscaler(make(J)).fit(JDA(x, dims, c_fit))
    p = P.PointWiseDownscaler(make(P), device="cpu", cell_chunk_size=20).fit(PDA(x, dims, c_fit))
    directions = ["transform"] if name.startswith("quantile_mapper") else ["transform", "inverse_transform"]
    for direction in directions:
        # the Cunnane inverse takes plotting positions as its input
        q = np.clip((xq - 270) / 30, -0.1, 1.1) if (name, direction) == ("cunnane", "inverse_transform") else xq
        want = getattr(j, direction)(JDA(q, dims, c_pred))
        got = getattr(p, direction)(PDA(q, dims, c_pred))
        assert got.dims == want.dims
        _same(got.values, want.values)
    if name == "trend":
        for key in ("slope_", "intercept_"):
            _same(p.get_attr(key).values, j.get_attr(key).values)


def test_pointwise_refuses_a_trend_aware_model_the_jax_rule_refuses(rng):
    """The batched registry refuses such a model, as the JAX rule does, and
    the grid runs it per cell, as the JAX package does; its single-cell fit
    then raises on the unsupported ``lr_kwargs`` in the first cell, as the
    JAX package's does."""
    dims, c_fit, _, x, y, _ = _grids(rng, C=40)
    make = lambda pkg: pkg.TrendAwareQuantileMappingRegressor(  # noqa: E731
        pkg.QuantileMappingReressor(), pkg.LinearTrendTransformer({"tol": 1e-3})
    )
    assert not P.models.batched.supports_batched(make(P))
    assert not J.models.batched.supports_batched(make(J))
    with pytest.raises(ValueError, match="unsupported lr_kwargs"):
        J.PointWiseDownscaler(make(J)).fit(JDA(x, dims, c_fit), JDA(y, dims, c_fit))
    with pytest.raises(ValueError, match="unsupported lr_kwargs"):
        P.PointWiseDownscaler(make(P), device="cpu").fit(PDA(x, dims, c_fit), PDA(y, dims, c_fit))
    ok = P.TrendAwareQuantileMappingRegressor(P.QuantileMappingReressor())
    assert P.models.batched.supports_batched(ok)
