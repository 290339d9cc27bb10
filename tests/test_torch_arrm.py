"""The port's ARRM (``models/arrm.py``), ``GroupedRegressor`` with the
index-flavoured ``PaddedDOYGrouper`` (``models/grouping.py``) and the
runner's per-cell object fallback (``pointwise.py``) against the JAX
package's on the CPU, in float64.

Tolerances:

* the 'arrm' breakpoints bitwise (the same picks of the same sorted values);
* 'fast' fits and predictions within ``atol = 1e-10`` (the same float64
  normal equations in another summation order);
* 'arrm' fits and predictions within ``rtol = 1e-8`` (and ``atol =
  1e-10``): its breaks can sit as close as the ±10-sample exclusion zones
  allow, which makes the hinge design ill-conditioned, so two float64
  normal-equation solves that sum in another order agree only to about
  eps·cond(AᵀA), in either package;
* 'auto' with as many breaks as the data has kinks within ``1e-8``: Adam
  reaches the same optimum and the rounding of 200 steps stays small;
* 'auto' with redundant breaks: the SSR is flat along them and not convex,
  so two runs that differ only in rounding end at other local minima (``PERF.md`` §2).  Held statistically: the
  median over cells of ``|SSR_port / SSR_jax - 1|`` within 1% and the
  median per-cell RMS of the prediction difference within a sixth of the
  noise sd (0.05 against 0.3);
* the fallback loop within ``1e-10`` (the same estimators on the same cell
  frames).
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import skdownscale_tpu as J
import skdownscale_tpu.models.arrm as JA
import skdownscale_tpu.models.grouping as JG
import skdownscale_tpu.models.trend as JT
from skdownscale_tpu.xlite import DataArray as JDA

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.models.arrm as PA
import skdownscale_tpu_torch.models.grouping as PG
import skdownscale_tpu_torch.models.trend as PT
from skdownscale_tpu_torch.convert import arrm_state_from_jax
from skdownscale_tpu_torch.models.base import SingleCellEstimator
from skdownscale_tpu_torch.xlite import DataArray as PDA

ATOL = 1e-10
RTOL_ARRM = 1e-8


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Drop this module's compiled JAX programs before and after it, as
    ``tests/test_torch_mbc.py`` does (one process holds every module's)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def single_cell_on_cpu(monkeypatch):
    """The single-cell API runs on the card by default; these tests ask for
    the CPU (float64)."""
    monkeypatch.setattr(SingleCellEstimator, "single_cell_device", torch.device("cpu"))


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_allclose(got, want, rtol=rtol, atol=atol)


def _rtol(fit_option):
    return RTOL_ARRM if fit_option == "arrm" else 0.0


def _truth(x):
    return np.where(x < 0, -1.0 * x, np.where(x < 5, 2.0 * x, 10 + 0.5 * (x - 5)))


def _cells(rng, C, T):
    """Config 6's data (bench.py:346-351): three segments plus noise."""
    x = rng.uniform(-10, 15, (C, T))
    return x, _truth(x) + rng.normal(0, 0.3, (C, T))


def _low_kink(rng, C, T):
    """Sorted y marginals whose smallest value lies far below the rest: only
    the first trailing window holds it, so its r² is the lowest and the
    lower-half pass picks its midpoint, below the exclusion half-width where
    the window is narrow enough (``center < half``: the reference's slice
    assignment wraps and masks nothing, so the same index is picked again)."""
    x = rng.uniform(0, 10, (C, T))
    y = x + rng.normal(0, 0.01, (C, T))
    lo = np.argmin(y, axis=1)
    y[np.arange(C), lo] -= 30.0
    return x, y


def _picks(xs, values):
    return np.searchsorted(xs, values)


@pytest.mark.parametrize("T", [30, 220, 300, 301, 1000])
@pytest.mark.parametrize("data", ["config6", "low_kink"])
def test_breakpoints_bitwise(rng, T, data):
    """Batched search against the JAX core, cell by cell, for odd window
    widths (T = 220, 300, 301: width 11, 15, 15, whose banker's-rounded
    midpoints collide) and even ones, and for the ``center < half`` quirk."""
    x, y = (_cells if data == "config6" else _low_kink)(rng, 6, T)
    xs, ys = np.sort(x, 1), np.sort(y, 1)
    for mb in (6, 4, 1):
        got = PA._arrm_breakpoints_core(torch.from_numpy(xs), torch.from_numpy(ys),
                                        window_width=0.05, max_breakpoints=mb).numpy()
        want = np.stack([np.asarray(JA._arrm_breakpoints_core(
            jnp.asarray(xs[c]), jnp.asarray(ys[c]), window_width=0.05, max_breakpoints=mb))
            for c in range(6)])
        npt.assert_array_equal(got, want)
        width = PA._geometry(T, 0.05)[1]
        if data == "low_kink" and mb == 6 and round(width / 2) < 10:
            picks = np.stack([_picks(xs[c], got[c]) for c in range(6)])
            assert (picks < 10).any(), picks  # the quirk's case is reached


def test_breakpoints_entry_point_bitwise(rng):
    x, y = _cells(rng, 1, 500)
    got = PA.arrm_breakpoints(x[0][:, None], y[0], 0.05, 6, device="cpu")
    npt.assert_array_equal(got, JA.arrm_breakpoints(x[0][:, None], y[0], 0.05, 6))
    with pytest.raises(ValueError, match="same length"):
        PA.arrm_breakpoints(x[0][:, None], y[0][:-1], 0.05, 6, device="cpu")
    with pytest.raises(ValueError, match="1 feature"):
        PA.arrm_breakpoints(np.stack([x[0], x[0]], 1), y[0], 0.05, 6, device="cpu")


@pytest.mark.parametrize("fit_option", ["fast", "arrm"])
@pytest.mark.parametrize("n_segments", [6, 3, 1])
def test_batched_fit_predict_match_jax(rng, fit_option, n_segments):
    x, y = _cells(rng, 8, 400)
    js = JA.arrm_fit_batched(jnp.asarray(x), jnp.asarray(y), fit_option=fit_option, n_segments=n_segments)
    ps = PA.arrm_fit_batched(torch.from_numpy(x), torch.from_numpy(y), fit_option=fit_option,
                             n_segments=n_segments)
    if fit_option == "arrm":  # the same picks of the same sorted values
        npt.assert_array_equal(ps.breaks.numpy(), np.asarray(js.breaks))
    for a, b in zip(ps, js):
        _close(a, b, rtol=_rtol(fit_option))
    xq = rng.uniform(-12, 17, (8, 150))
    _close(PA.arrm_predict_batched(ps, torch.from_numpy(xq)),
           JA.arrm_predict_batched(js, jnp.asarray(xq)), rtol=_rtol(fit_option))


def test_auto_matches_jax_with_as_many_breaks_as_kinks(rng):
    x, y = _cells(rng, 8, 300)
    js = JA.arrm_fit_batched(jnp.asarray(x), jnp.asarray(y), fit_option="auto", n_segments=3)
    ps = PA.arrm_fit_batched(torch.from_numpy(x), torch.from_numpy(y), fit_option="auto", n_segments=3)
    _close(ps.breaks, js.breaks, atol=1e-8)
    _close(PA.arrm_predict_batched(ps, torch.from_numpy(x)),
           JA.arrm_predict_batched(js, jnp.asarray(x)), atol=1e-8)


def test_auto_with_redundant_breaks_within_the_stated_tolerance(rng):
    x, y = _cells(rng, 12, 300)
    js = JA.arrm_fit_batched(jnp.asarray(x), jnp.asarray(y), fit_option="auto", n_segments=6)
    ps = PA.arrm_fit_batched(torch.from_numpy(x), torch.from_numpy(y), fit_option="auto", n_segments=6)
    pj = np.asarray(JA.arrm_predict_batched(js, jnp.asarray(x)))
    pp = PA.arrm_predict_batched(ps, torch.from_numpy(x)).numpy()
    ratio = ((pp - y) ** 2).sum(1) / ((pj - y) ** 2).sum(1)
    assert np.median(np.abs(ratio - 1)) <= 0.01, ratio
    assert np.median(np.sqrt(((pp - pj) ** 2).mean(1))) <= 0.05
    # every fit is a fit: no cell's residual sd far above the noise's 0.3
    assert np.sqrt(((pp - y) ** 2).mean(1)).max() < 1.0


@pytest.mark.parametrize("fit_option", ["fast", "arrm", "auto"])
def test_wrapper_matches_jax(rng, fit_option):
    x, y = _cells(rng, 1, 400)
    n_seg = 3 if fit_option == "auto" else 6
    jm = J.PiecewiseLinearRegression(n_segments=n_seg, fit_option=fit_option).fit(x[0][:, None], y[0])
    pm = P.PiecewiseLinearRegression(n_segments=n_seg, fit_option=fit_option).fit(x[0][:, None], y[0])
    atol = 1e-8 if fit_option == "auto" else ATOL
    _close(pm.fit_breaks_, jm.fit_breaks_, atol=atol)
    assert pm.model_ is pm and pm.n_features_in_ == 1
    xq = rng.uniform(-12, 17, (90, 1))
    _close(pm.predict(xq), jm.predict(xq), atol=atol, rtol=_rtol(fit_option))
    with pytest.raises(ValueError, match="fit_option"):
        P.PiecewiseLinearRegression(fit_option="bogus").fit(x[0][:, None], y[0])


def _grid(rng, C=20, T=300):
    x, y = _cells(rng, C, T)
    x, y = x.T.copy(), y.T.copy()
    x[:, [0, 5]] = np.nan
    y[:, [0, 5]] = np.nan
    idx = pd.date_range("1990-01-01", periods=T, freq="D")
    return ("time", "cell"), {"time": idx, "cell": np.arange(C)}, x, y


@pytest.mark.parametrize("fit_option", ["fast", "arrm"])
def test_registry_grid_and_fit_breaks_match_jax(rng, fit_option):
    dims, c, x, y = _grid(rng)
    j = J.PointWiseDownscaler(J.PiecewiseLinearRegression(n_segments=6, fit_option=fit_option))
    j.fit(JDA(x, dims, c), JDA(y, dims, c))
    p = P.PointWiseDownscaler(P.PiecewiseLinearRegression(n_segments=6, fit_option=fit_option),
                              device="cpu", cell_chunk_size=11)
    p.fit(PDA(x, dims, c), PDA(y, dims, c))
    _close(p.predict(PDA(x, dims, c)).values, j.predict(JDA(x, dims, c)).values,
           rtol=_rtol(fit_option))
    _close(p.get_attr("fit_breaks_").values, j.get_attr("fit_breaks_").values)


def test_jax_fitted_state_predicts_the_same_in_the_port(rng):
    x, y = _cells(rng, 5, 300)
    js = JA.arrm_fit_batched(jnp.asarray(x), jnp.asarray(y), fit_option="arrm", n_segments=6)
    ps = arrm_state_from_jax(*(np.asarray(a) for a in js), device="cpu")
    _close(PA.arrm_predict_batched(ps, torch.from_numpy(x)), JA.arrm_predict_batched(js, jnp.asarray(x)))


# ----------------------------------------------------------------------
# GroupedRegressor + PaddedDOYGrouper
# ----------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 5, 15])
def test_padded_doy_grouper_groups_bitwise(window):
    index = pd.date_range("1999-03-01", periods=800)
    got = PG.PaddedDOYGrouper(index, window).groups
    want = JG.PaddedDOYGrouper(index, window).groups
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        npt.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("inner", ["sklearn", "arrm_fast"])
def test_grouped_regressor_matches_jax(rng, inner):
    from sklearn.linear_model import LinearRegression

    index = pd.date_range("2000-01-01", periods=730)
    X = pd.DataFrame({"x": rng.uniform(-10, 15, 730)}, index=index)
    y = pd.DataFrame({"y": _truth(X["x"].to_numpy()) + rng.normal(0, 0.3, 730)}, index=index)

    def make(pkg, grouping):
        est = LinearRegression if inner == "sklearn" else pkg.PiecewiseLinearRegression
        kw = None if inner == "sklearn" else {"n_segments": 2, "fit_option": "fast"}
        return pkg.GroupedRegressor(estimator=est, fit_grouper=grouping.PaddedDOYGrouper,
                                    predict_grouper=lambda t: t.dayofyear, estimator_kwargs=kw,
                                    fit_grouper_kwargs={"window": 5})

    got = make(P, PG).fit(X, y).predict(X)
    want = make(J, JG).fit(X, y).predict(X)
    assert got.shape == want.shape == (730, 1)
    _close(got, want)


# ----------------------------------------------------------------------
# the per-cell object fallback of PointWiseDownscaler
# ----------------------------------------------------------------------


def _fallback_grid(rng, C=12, T=200):
    idx = pd.date_range("1990-01-01", periods=T, freq="D")
    x = 283.0 + rng.normal(0, 2, (T, C)) + 0.004 * np.arange(T)[:, None]
    y = 0.8 * x + 50.0 + rng.normal(0, 0.5, (T, C))
    x[:, [0, 4]] = np.nan
    y[:, [0, 4]] = np.nan
    return ("time", "cell"), {"time": idx, "cell": np.arange(C)}, x, y


class _PTrend(PT.LinearTrendTransformer):
    """A trend transformer of another class: the batched rule refuses it."""


class _JTrend(JT.LinearTrendTransformer):
    pass


def _fallback_models(pkg):
    from sklearn.linear_model import LinearRegression
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler

    trend = _PTrend if pkg is P else _JTrend
    return {
        "linear_regression": lambda: LinearRegression(),
        "pipeline": lambda: Pipeline([("scale", StandardScaler()), ("lm", LinearRegression())]),
        "trend_aware_custom": lambda: pkg.TrendAwareQuantileMappingRegressor(
            pkg.QuantileMappingReressor(extrapolate="both"), trend()),
    }


@pytest.mark.parametrize("name", sorted(_fallback_models(P)))
def test_fallback_predict_matches_jax(rng, name):
    dims, c, x, y = _fallback_grid(rng)
    pmodel = _fallback_models(P)[name]()
    assert not P.models.batched.supports_batched(pmodel)
    j = J.PointWiseDownscaler(_fallback_models(J)[name]()).fit(JDA(x, dims, c), JDA(y, dims, c))
    p = P.PointWiseDownscaler(pmodel, device="cpu").fit(PDA(x, dims, c), PDA(y, dims, c))
    assert p._state is None and p._models[0] is None and p._models[1] is not None
    xq = x[:150] + 1.0
    cq = {"time": pd.date_range("2050-01-01", periods=150, freq="D"), "cell": c["cell"]}
    for q, cc in ((x, c), (xq, cq)):
        got = p.predict(PDA(q, dims, cc))
        assert isinstance(got, PDA) and got.dims == dims
        _close(got.values, j.predict(JDA(q, dims, cc)).values)
    if name == "linear_regression":
        _close(p.get_attr("intercept_").values, j.get_attr("intercept_").values)


def test_fallback_transform_and_inverse_match_jax(rng):
    from sklearn.preprocessing import StandardScaler

    dims, c, x, _ = _fallback_grid(rng)
    j = J.PointWiseDownscaler(StandardScaler()).fit(JDA(x, dims, c))
    p = P.PointWiseDownscaler(StandardScaler(), device="cpu").fit(PDA(x, dims, c))
    for direction in ("transform", "inverse_transform"):
        got = getattr(p, direction)(PDA(x, dims, c))
        _close(got.values, getattr(j, direction)(JDA(x, dims, c)).values)


def test_single_cell_zscore_and_arrm_run_on_the_card_or_raise(rng, monkeypatch):
    """Both single-cell APIs default to the card and raise without one,
    saying how to ask for the CPU."""
    monkeypatch.setattr(SingleCellEstimator, "single_cell_device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _cells(rng, 1, 400)
    idx = pd.date_range("1990-01-01", periods=400, freq="D")
    X, Y = pd.DataFrame({"t": x[0]}, index=idx), pd.DataFrame({"t": y[0]}, index=idx)
    for est in (P.ZScoreRegressor(), P.PiecewiseLinearRegression(fit_option="fast")):
        with pytest.raises(RuntimeError, match="single_cell_device = torch.device\\('cpu'\\)"):
            est.fit(X, Y)
