"""The port's monthly BCSD slice against the JAX package on the CPU, in
float64: the modules that hold a kernel (``cunnane_fit_padded`` runs K1,
``grouped_qm_transform`` runs K2), the rolling mean in both forms,
``ols_1d``, the single-cell wrappers, the grid runner end to end, and
fitted state carried across packages.

Tolerances: host tables and sorted CDF values bitwise; mapped values within
``atol=1e-10`` (sums over a group may add in another order, a few ulp at
~300 K, while a rank that moved by one would move a value by a whole CDF
step, orders of magnitude above it).
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import skdownscale_tpu as J
import skdownscale_tpu.models.bcsd as jb
import skdownscale_tpu.models.grouped as jg
import skdownscale_tpu.ops.regression as jreg
import skdownscale_tpu.ops.rolling as jr
from skdownscale_tpu.xlite import DataArray as JDA

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.models.bcsd as pb
import skdownscale_tpu_torch.models.grouped as pg
import skdownscale_tpu_torch.ops.regression as preg
import skdownscale_tpu_torch.ops.rolling as pr
from skdownscale_tpu_torch.convert import bcsd_state_from_jax, bcsd_state_to_numpy
from skdownscale_tpu_torch.xlite import DataArray as PDA

ATOL = 1e-10


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _month_series(rng, C, T, start="1980-01-01", quantize=False, shift=0.0):
    idx = pd.date_range(start, periods=T, freq="MS")
    seas = 8 * np.sin(2 * np.pi * (idx.month.values - 1) / 12)
    x = 283 + shift + seas + rng.normal(0, 2, (C, T)) + 1.5
    y = 282 + seas + rng.normal(0, 1.8, (C, T))
    if quantize:
        x, y = np.round(x), np.round(y)
    return idx, x, y


# ----------------------------------------------------------------------
# ols_1d
# ----------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_ols_1d_matches_jax(rng, weighted):
    x = rng.normal(size=(6, 4, 10))
    y = 2.0 * x + rng.normal(size=(6, 4, 10))
    x[0, 0] = 3.0  # zero-variance design: slope 0, intercept = mean
    w = (rng.random((4, 10)) > 0.3).astype(float) if weighted else None
    js, ji = jreg.ols_1d(jnp.asarray(x), jnp.asarray(y), None if w is None else jnp.asarray(w))
    ps, pi = preg.ols_1d(_t(x), _t(y), None if w is None else _t(w))
    npt.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=ATOL)
    npt.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0, atol=ATOL)
    assert ps[0, 0].item() == 0.0


# ----------------------------------------------------------------------
# rolling mean, both forms
# ----------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [False, True])
def test_rolling_flat_matches_jax_cpu_path(rng, quantize):
    idx, x, _ = _month_series(rng, 5, 137, quantize=quantize)
    g = pb._pandas_partition(idx, pb.MONTH_GROUPER)
    jg_ = jb._pandas_partition(idx, jb.MONTH_GROUPER)
    xg = pg.gather_groups(_t(x), g, fill=0.0)
    want = jr.rolling_mean_grouped_flat(jg.gather_groups(jnp.asarray(x), jg_, fill=0.0), 9, jg_.mask)
    got = pr.rolling_mean_grouped_flat(xg, 9, g.mask)
    npt.assert_array_equal(got.numpy(), np.asarray(want))  # same adds, same order
    plan = pb.BcsdTemperature()._predict_plan(g, idx)
    jplan = jb.BcsdTemperature()._predict_plan(jg_, idx)
    assert not pr.use_rolling_matmul(_t(x))  # CPU takes the flat form
    npt.assert_array_equal(
        pb._climate_trend_rolled(_t(x), plan, 9, 137).numpy(),
        np.asarray(jb._climate_trend_rolled(jnp.asarray(x), jplan, 9, 137)),
    )


def test_rolling_matrix_form_matches_jax_matmul(rng):
    idx, x, _ = _month_series(rng, 5, 137)
    g = pb._pandas_partition(idx, pb.MONTH_GROUPER)
    jplan = jb.BcsdTemperature()._predict_plan(jb._pandas_partition(idx, jb.MONTH_GROUPER), idx)
    saved = jr._MATMUL_OVERRIDE
    try:
        jr._MATMUL_OVERRIDE = True
        want = np.asarray(jb._climate_trend_rolled(jnp.asarray(x), jplan, 9, 137))
    finally:
        jr._MATMUL_OVERRIDE = saved
    got = pr.rolling_mean_grouped_matmul(_t(x), g, 9).numpy()
    npt.assert_allclose(got, want, rtol=0, atol=ATOL)
    flat = pb._climate_trend_rolled(_t(x), pb.BcsdTemperature()._predict_plan(g, idx), 9, 137)
    npt.assert_allclose(got, flat.numpy(), rtol=0, atol=ATOL)


# ----------------------------------------------------------------------
# the modules that hold a kernel
# ----------------------------------------------------------------------


@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_cunnane_fit_padded_matches_jax(rng, detrend, quantize):
    idx, _, y = _month_series(rng, 7, 137, quantize=quantize)
    g = pb._pandas_partition(idx, pb.MONTH_GROUPER)
    jg_ = jb._pandas_partition(idx, jb.MONTH_GROUPER)
    got = pg.grouped_qm_fit(_t(y), g, detrend=detrend)
    want = jg.grouped_qm_fit(jnp.asarray(y), jg_, detrend=detrend)
    npt.assert_array_equal(got.pp.numpy(), np.asarray(want.pp))
    npt.assert_allclose(got.trend_slope.numpy(), np.asarray(want.trend_slope), rtol=0, atol=ATOL)
    npt.assert_allclose(
        got.trend_intercept.numpy(), np.asarray(want.trend_intercept), rtol=0, atol=ATOL
    )
    if detrend:
        npt.assert_allclose(got.vals.numpy(), np.asarray(want.vals), rtol=0, atol=ATOL)
    else:
        npt.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))


@pytest.mark.parametrize(
    "extrapolate,detrend,quantize",
    [("both", False, False), ("both", False, True), ("min", True, False), ("max", False, True), (None, False, False)],
)
def test_grouped_qm_transform_matches_jax(rng, extrapolate, detrend, quantize):
    idx, x, y = _month_series(rng, 6, 120, quantize=quantize)
    idx_p, xp, _ = _month_series(rng, 6, 97, start="2050-03-01", quantize=quantize, shift=3.0)
    pm, jm = pb.BcsdTemperature(), jb.BcsdTemperature()
    pfg, jfg = pm._fit_groups(idx), jm._fit_groups(idx)
    pplan, jplan = pm._predict_plan(pfg, idx_p), jm._predict_plan(jfg, idx_p)
    t2f = pplan.transform_to_fit
    G, L = pfg.indices.shape
    cols = (t2f[:, None] * L + np.arange(L)).reshape(-1)
    pq = pg.grouped_qm_fit(_t(y), pfg, detrend=detrend)
    jq = jg.grouped_qm_fit(jnp.asarray(y), jfg, detrend=detrend)
    pa = pg.GroupedCdf(pq.pp[cols], pq.vals[..., cols], pq.trend_slope[..., t2f], pq.trend_intercept[..., t2f])
    ja = jg.GroupedCdf(jq.pp[cols], jq.vals[..., cols], jq.trend_slope[..., t2f], jq.trend_intercept[..., t2f])
    kw = dict(extrapolate=extrapolate, detrend=detrend)
    counts, valid = pfg.counts[t2f], pfg.mask[t2f].reshape(-1)
    got = pg.grouped_qm_transform(pa, counts, valid, _t(xp), pplan.transform, **kw)
    want = jg.grouped_qm_transform(ja, counts, valid, jnp.asarray(xp), jplan.transform, **kw)
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# ----------------------------------------------------------------------
# the slice as a whole
# ----------------------------------------------------------------------


def _grids(rng, quantize=False, precip=False, C=64, T=192):
    idx = pd.date_range("1980-01-01", periods=T, freq="MS")
    if precip:
        x = rng.gamma(2.0, 30.0, (T, C)) + 1
        y = rng.gamma(2.2, 25.0, (T, C)) + 1
        xf = rng.gamma(2.1, 33.0, (T, C)) + 1
    else:
        seas = (8 * np.sin(2 * np.pi * (idx.month.values - 1) / 12))[:, None]
        x = 283 + seas + rng.normal(0, 2, (T, C)) + 1.5
        y = 282 + seas + rng.normal(0, 1.8, (T, C))
        xf = 286 + seas + rng.normal(0, 2.5, (T, C)) + 1.5  # many hi-tail queries
        if quantize:
            x, y, xf = np.round(x), np.round(y), np.round(xf)
    x[:, [0, 5, 33]] = np.nan  # NaN cells
    xf[:, [0, 5, 33]] = np.nan
    coords = {"time": idx, "point": np.arange(C)}
    return coords, x, y, xf


@pytest.mark.parametrize(
    "cls,return_anoms,quantize",
    [
        ("BcsdTemperature", False, False),
        ("BcsdTemperature", True, False),
        ("BcsdTemperature", False, True),
        ("BcsdPrecipitation", True, False),
        ("BcsdPrecipitation", False, False),
    ],
)
def test_pointwise_bcsd_matches_jax(rng, cls, return_anoms, quantize):
    coords, x, y, xf = _grids(rng, quantize=quantize, precip=cls == "BcsdPrecipitation")
    dims = ("time", "point")
    j = J.PointWiseDownscaler(getattr(J, cls)(return_anoms=return_anoms))
    j.fit(JDA(x, dims, coords), JDA(y, dims, coords))
    p = P.PointWiseDownscaler(getattr(P, cls)(return_anoms=return_anoms), device="cpu", cell_chunk_size=40)
    p.fit(PDA(x, dims, coords), PDA(y, dims, coords))
    for q in (x, xf):
        want = j.predict(JDA(q, dims, coords)).values
        got = p.predict(PDA(q, dims, coords))
        assert isinstance(got, PDA) and got.dims == dims and got.values.dtype == np.float64
        npt.assert_array_equal(np.isnan(got.values), np.isnan(want))
        npt.assert_allclose(got.values, want, rtol=0, atol=ATOL)
    npt.assert_allclose(
        p.get_attr("y_climo_").values, j.get_attr("y_climo_").values, rtol=0, atol=ATOL
    )
    assert p.get_attr("y_climo_").dims == j.get_attr("y_climo_").dims


@pytest.mark.parametrize("return_anoms", [False, True])
def test_single_cell_wrapper_matches_jax(rng, return_anoms):
    idx, x, y = _month_series(rng, 1, 240, quantize=True)
    X = pd.DataFrame({"t": x[0]}, index=idx)
    Y = pd.DataFrame({"t": y[0]}, index=idx)
    j = jb.BcsdTemperature(return_anoms=return_anoms).fit(X, Y)
    p = pb.BcsdTemperature(return_anoms=return_anoms).fit(X, Y)
    assert sorted(p.get_params()) == sorted(j.get_params())
    npt.assert_allclose(p.y_climo_, j.y_climo_, rtol=0, atol=ATOL)
    got, want = p.predict(X), j.predict(X)
    assert isinstance(got, pd.DataFrame) and got.index.equals(want.index)
    npt.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=ATOL)


def test_unported_parts_raise_naming_the_roadmap(rng):
    idx, x, y = _month_series(rng, 1, 60)
    X = pd.DataFrame({"t": x[0]}, index=idx)
    Y = pd.DataFrame({"t": y[0]}, index=idx)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pb.BcsdTemperature(time_grouper="daily_nasa-nex").fit(X, Y)
    m = pb.BcsdTemperature().fit(X, Y)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        m.quantile_mappers_
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        P.PointWiseDownscaler(object.__new__(type("Est", (), {"fit": None})), device="cpu").fit(
            PDA(x.T, ("time", "point"), {"time": idx}), PDA(y.T, ("time", "point"), {"time": idx})
        )


def test_jax_fitted_state_predicts_the_same_in_the_port(rng):
    idx, x, y = _month_series(rng, 9, 144)
    idx_p, xp, _ = _month_series(rng, 9, 120, start="2040-01-01", shift=2.0)
    jm, pm = jb.BcsdTemperature(), pb.BcsdTemperature()
    jfg, pfg = jm._fit_groups(idx), pm._fit_groups(idx)
    jstate = jb._jit_fit(jfg, True, 0.4, 0.4, False)(jnp.asarray(x), jnp.asarray(y))
    jpred = jb._jit_predict(jm._predict_plan(jfg, idx_p), "temperature", True, 0.4, 0.4, "both", 10, False)
    want = np.asarray(jpred(jstate, jnp.asarray(xp)))
    arrays = [np.asarray(a) for a in jstate]
    state = bcsd_state_from_jax(*arrays, device="cpu")
    for a, b in zip(bcsd_state_to_numpy(state), arrays):
        npt.assert_array_equal(a, b)
    got = pb.bcsd_predict(state, _t(xp), pm._predict_plan(pfg, idx_p)).numpy()
    npt.assert_allclose(got, want, rtol=0, atol=ATOL)
