"""The port's streaming BCSD (lazy fit, group-chunked predict) and daily BCSD
(``time_grouper="daily_nasa-nex"``) against the JAX package on the CPU.

Host tables (chunk tables, the mean-pooling matrix, the daily predict plan)
are held bitwise.  Climatologies and predictions, in float64, are held
within ``atol=1e-10``: sums may add in another order (a few ulp at ~300 K),
while a rank that moved by one would move a value by a whole CDF step.

Interior NaN (H1): the JAX package's default CPU route pads each fit window
with +inf before it sorts, so a NaN member sorts after the pads; its slide
kernel K5, which it runs on the TPU, sorts pads after every value.  The
port takes the slide route on every device, so the parity tests against the
default CPU route use ``y`` without interior NaN, and
:func:`test_interior_nan_follows_the_slide_rule` pins the interior-NaN case
against the JAX package's forced slide route.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import skdownscale_tpu as J
import skdownscale_tpu.models.batched as jbat
import skdownscale_tpu.models.bcsd as jb
import skdownscale_tpu.models.streaming as jst
from skdownscale_tpu.ops import rowsort
from skdownscale_tpu.xlite import DataArray as JDA

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.models.batched as pbat
import skdownscale_tpu_torch.models.bcsd as pb
import skdownscale_tpu_torch.models.streaming as pst
import skdownscale_tpu_torch.utils.timeindex as pt
from skdownscale_tpu_torch.convert import bcsd_lazy_state_from_jax, bcsd_lazy_state_to_numpy
from skdownscale_tpu_torch.models.base import SingleCellEstimator
from skdownscale_tpu_torch.xlite import DataArray as PDA

ATOL = 1e-10
DAILY = "daily_nasa-nex"


@pytest.fixture(autouse=True)
def single_cell_on_cpu(monkeypatch):
    """The single-cell API runs on the card by default; these tests ask for
    the CPU (float64)."""
    monkeypatch.setattr(SingleCellEstimator, "single_cell_device", torch.device("cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _daily(rng, C=3, years=4, start="2000-01-01", shift=0.0):
    idx = pd.date_range(start, periods=years * 365 + 1, freq="D")
    seas = 10 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25)
    x = 283 + shift + seas + rng.normal(0, 2, (C, len(idx))) + 1.2
    y = 282 + seas + rng.normal(0, 1.7, (C, len(idx)))
    return idx, x, y


def _monthly(rng, C=5, years=12):
    idx = pd.date_range("1980-01-01", periods=years * 12, freq="MS")
    seas = 8 * np.sin(2 * np.pi * (idx.month.to_numpy() - 1) / 12)
    x = 283 + seas + rng.normal(0, 2, (C, len(idx))) + 1.5
    y = 282 + seas + rng.normal(0, 1.8, (C, len(idx)))
    return idx, x, y


def _precip(x, y):
    return np.abs(x) * 0.1 + 1.0, np.abs(y) * 0.1 + 1.0


def _models(cls, **kw):
    return getattr(pb, cls)(**kw), getattr(jb, cls)(**kw)


def _groups_equal(a, b):
    for f in ("indices", "mask", "counts", "keys", "labels"):
        ga, gb = getattr(a, f), getattr(b, f)
        assert (ga is None) == (gb is None), f
        if ga is not None:
            npt.assert_array_equal(ga, gb, err_msg=f)


# ----------------------------------------------------------------------
# host tables
# ----------------------------------------------------------------------


@pytest.mark.parametrize("group_chunk", [3, 8, 12])
@pytest.mark.parametrize("source", ["raw", "state"])
@pytest.mark.parametrize("flavor", ["monthly", "daily"])
def test_build_stream_tables_bitwise(rng, flavor, source, group_chunk):
    if flavor == "daily":
        idx, _, _ = _daily(rng, C=1)
        pm, jm = _models("BcsdTemperature", time_grouper=DAILY)
    else:
        idx, _, _ = _monthly(rng, C=1)
        pm, jm = _models("BcsdTemperature")
    pplan = pm._predict_plan(pm._fit_groups(idx), idx)
    jplan = jm._predict_plan(jm._fit_groups(idx), idx)
    kw = dict(group_chunk=group_chunk, source=source, n_endpoints=10)
    a = pst.build_stream_tables(pplan.fit, pplan.transform, pplan.transform_to_fit, **kw)
    b = jst.build_stream_tables(jplan.fit, jplan.transform, jplan.transform_to_fit, **kw)
    assert a._fields == b._fields
    for f, u, v in zip(a._fields, a, b):
        npt.assert_array_equal(u, v, err_msg=f)
        assert u.dtype == v.dtype, f


def test_padded_doy_grouper_matches_jax_and_the_grid_groups():
    """The iterator-flavoured grouper yields the JAX package's frames, with
    the members (leap-year rows first) of ``padded_doy_groups``."""
    idx = pd.date_range("1999-12-01", periods=500, freq="D")  # holds 2000-02-29
    df = pd.DataFrame({"t": np.arange(500, dtype=np.float64)}, index=idx)
    pgr, jgr = P.PaddedDOYGrouper(df), J.PaddedDOYGrouper(df)
    fit = pt.padded_doy_groups(pt.TimeIndex.from_pandas(idx), offset=15)
    keys = []
    for (pk, pf), (jk, jf) in zip(pgr, jgr):
        assert pk == jk
        pd.testing.assert_frame_equal(pf, jf)
        g = pk - 1
        npt.assert_array_equal(pf["t"].to_numpy(), fit.indices[g, : fit.counts[g]])
        keys.append(pk)
    assert keys == list(range(1, 367))
    pd.testing.assert_frame_equal(pgr.mean(), jgr.mean())


def test_membership_matrix_and_daily_plan_bitwise(rng):
    idx, _, _ = _daily(rng, C=1, years=5)
    idx_p = pd.date_range("2031-03-05", periods=3 * 365, freq="D")
    pm, jm = _models("BcsdTemperature", time_grouper=DAILY, return_anoms=False)
    pfg, jfg = pm._fit_groups(idx), jm._fit_groups(idx)
    _groups_equal(pfg, jfg)
    npt.assert_array_equal(pb._membership_matrix(pfg, len(idx)), jb._membership_matrix(jfg, len(idx)))
    pp, jp = pm._predict_plan(pfg, idx_p), jm._predict_plan(jfg, idx_p)
    for f in ("fit", "transform", "rolling"):
        _groups_equal(getattr(pp, f), getattr(jp, f))
    for f in ("transform_to_fit", "shift_labels"):
        npt.assert_array_equal(getattr(pp, f), getattr(jp, f))
        assert getattr(pp, f).dtype == getattr(jp, f).dtype
    assert pp.anom_labels is None and jp.anom_labels is None
    for f in ("consulted", "w0_idx", "add_idx", "rem_idx"):
        npt.assert_array_equal(getattr(pp.slide, f), getattr(jp.slide, f))
    assert (pp.slide.Lt, pp.slide.Lto) == (jp.slide.Lt, jp.slide.Lto)
    for gc in (3, 8, 12):
        assert pb._slide_n_rows(pp, gc) == jb._slide_n_rows(jp, gc)
    assert hash(pp) == hash(pm._predict_plan(pfg, idx_p))


# ----------------------------------------------------------------------
# lazy fit and streaming predict
# ----------------------------------------------------------------------


@pytest.mark.parametrize("flavor", ["monthly", "daily"])
def test_fit_lazy_climatologies_match_jax(rng, flavor):
    idx, x, y = _daily(rng) if flavor == "daily" else _monthly(rng)
    kw = dict(time_grouper=DAILY) if flavor == "daily" else {}
    pm, jm = _models("BcsdTemperature", **kw)
    pfg, jfg = pm._fit_groups(idx), jm._fit_groups(idx)
    for with_x in (True, False):
        got = pb.bcsd_fit_lazy(_t(x), _t(y), pfg, with_x_climo=with_x)
        want = jb.bcsd_fit_lazy(jnp.asarray(x), jnp.asarray(y), jfg, with_x_climo=with_x)
        npt.assert_array_equal(got.y.numpy(), np.asarray(want.y))
        npt.assert_allclose(got.aux.numpy(), np.asarray(want.aux), rtol=0, atol=ATOL)
    G = pfg.n_groups
    yc, xc = got.unpack(G)
    assert yc.shape == (x.shape[0], G) and not xc.any()


@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("variable", ["temperature", "precipitation"])
def test_daily_streaming_matches_jax(rng, variable, detrend):
    """detrend=False takes the slide route (plain K5), detrend=True the raw
    route (each chunk gathers and sorts its windows)."""
    idx, x, y = _daily(rng)
    if variable == "precipitation":
        x, y = _precip(x, y)
    cls = "BcsdTemperature" if variable == "temperature" else "BcsdPrecipitation"
    pm, jm = _models(cls, time_grouper=DAILY, return_anoms=False)
    pfg, jfg = pm._fit_groups(idx), jm._fit_groups(idx)
    pplan, jplan = pm._predict_plan(pfg, idx), jm._predict_plan(jfg, idx)
    with_x = variable == "temperature"
    kw = dict(variable=variable, return_anoms=False, detrend=detrend, group_chunk=8)
    got = pb.bcsd_predict_streaming(pb.bcsd_fit_lazy(_t(x), _t(y), pfg, with_x_climo=with_x), _t(x), pplan, **kw)
    jstate = jb.bcsd_fit_lazy(jnp.asarray(x), jnp.asarray(y), jfg, with_x_climo=with_x)
    want = np.asarray(jb.bcsd_predict_streaming(jstate, jnp.asarray(x), jplan, **kw))
    assert got.dtype == torch.float64
    npt.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("group_chunk", [3, 8, 12])
def test_monthly_streaming_dense_and_lazy_match_jax(rng, group_chunk):
    idx, x, y = _monthly(rng)
    x[1, 37] = np.nan  # a NaN query stays local
    pm, jm = _models("BcsdTemperature")
    pfg, jfg = pm._fit_groups(idx), jm._fit_groups(idx)
    pplan, jplan = pm._predict_plan(pfg, idx), jm._predict_plan(jfg, idx)
    kw = dict(variable="temperature", return_anoms=True, group_chunk=group_chunk)
    states = [
        (pb.bcsd_fit(_t(x), _t(y), pfg), jb.bcsd_fit(jnp.asarray(x), jnp.asarray(y), jfg)),
        (pb.bcsd_fit_lazy(_t(x), _t(y), pfg), jb.bcsd_fit_lazy(jnp.asarray(x), jnp.asarray(y), jfg)),
    ]
    dense = pb.bcsd_predict(states[0][0], _t(x), pplan, variable="temperature").numpy()
    for ps_, js_ in states:
        got = pb.bcsd_predict_streaming(ps_, _t(x), pplan, **kw).numpy()
        want = np.asarray(jb.bcsd_predict_streaming(js_, jnp.asarray(x), jplan, **kw))
        npt.assert_array_equal(np.isnan(got), np.isnan(want))
        npt.assert_allclose(got, want, rtol=0, atol=ATOL)
        # the lazy fit pools x over all of T in one product, so cell 1's NaN
        # reaches every climatology of cell 1 (in the JAX package too)
        keep = [0, 2, 3, 4]
        npt.assert_allclose(got[keep], dense[keep], rtol=0, atol=ATOL)
        assert np.isnan(got[1, 37]) and np.isfinite(got[keep]).all()


# ----------------------------------------------------------------------
# the slice end to end
# ----------------------------------------------------------------------


@pytest.mark.parametrize("cls", ["BcsdTemperature", "BcsdPrecipitation"])
def test_pointwise_daily_matches_jax(rng, cls):
    idx, x, y = _daily(rng, C=5, years=3)
    _, xf, _ = _daily(rng, C=5, years=3, shift=2.0)
    if cls == "BcsdPrecipitation":
        x, y = _precip(x, y)
        xf = np.abs(xf) * 0.11 + 1.0
    x, y, xf = x.T.copy(), y.T.copy(), xf.T.copy()  # (time, point)
    x[:, [0, 3]] = np.nan  # NaN cells
    xf[:, [0, 3]] = np.nan
    dims, coords = ("time", "point"), {"time": idx, "point": np.arange(5)}
    j = J.PointWiseDownscaler(getattr(J, cls)(time_grouper=DAILY, return_anoms=False))
    j.fit(JDA(x, dims, coords), JDA(y, dims, coords))
    p = P.PointWiseDownscaler(getattr(P, cls)(time_grouper=DAILY, return_anoms=False), device="cpu")
    p.fit(PDA(x, dims, coords), PDA(y, dims, coords))
    for q in (x, xf):
        want = j.predict(JDA(q, dims, coords)).values
        got = p.predict(PDA(q, dims, coords))
        assert got.dims == dims and got.values.dtype == np.float64
        npt.assert_array_equal(np.isnan(got.values), np.isnan(want))
        npt.assert_allclose(got.values, want, rtol=0, atol=ATOL)
    pc, jc = p.get_attr("y_climo_"), j.get_attr("y_climo_")
    assert pc.values.shape == (366, 5) and pc.dims == jc.dims
    npt.assert_allclose(pc.values, jc.values, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cls", ["BcsdTemperature", "BcsdPrecipitation"])
def test_single_cell_daily_wrapper_matches_jax(rng, cls):
    idx, x, y = _daily(rng, C=1, years=3)
    if cls == "BcsdPrecipitation":
        x, y = _precip(x, y)
    X = pd.DataFrame({"t": x[0]}, index=idx)
    Y = pd.DataFrame({"t": y[0]}, index=idx)
    pm, jm = _models(cls, time_grouper=DAILY, return_anoms=False)
    pm.fit(X, Y)
    jm.fit(X, Y)
    assert pm.y_climo_.shape == (366,)
    npt.assert_allclose(pm.y_climo_, jm.y_climo_, rtol=0, atol=ATOL)
    got, want = pm.predict(X), jm.predict(X)
    assert isinstance(got, pd.DataFrame) and got.index.equals(want.index)
    npt.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=ATOL)


def test_daily_return_anoms_raises_as_jax(rng):
    idx, x, y = _daily(rng, C=2, years=2)
    X = pd.DataFrame({"t": x[0]}, index=idx)
    Y = pd.DataFrame({"t": y[0]}, index=idx)
    pm, jm = _models("BcsdTemperature", time_grouper=DAILY, return_anoms=True)
    with pytest.raises(ValueError) as jerr:
        jm.fit(X, Y).predict(X)
    with pytest.raises(ValueError) as perr:
        pm.fit(X, Y).predict(X)
    assert str(perr.value) == str(jerr.value)
    st = pbat.batched_fit(pm, idx, _t(x)[..., None], _t(y))
    with pytest.raises(ValueError, match="return_anoms=True"):
        pbat.batched_predict(pm, st, idx, _t(x)[..., None], idx)
    with pytest.raises(ValueError, match="daily_nasa-nex"):
        pb.BcsdTemperature(time_grouper="D").fit(X, Y)


def test_registry_takes_the_lazy_state(rng, monkeypatch):
    """Daily always streams; monthly streams from the cell threshold up and
    agrees with its dense path."""
    idx, x, y = _daily(rng, C=2, years=2)
    m = pb.BcsdTemperature(time_grouper=DAILY, return_anoms=False)
    st = pbat.batched_fit(m, idx, _t(x)[..., None], _t(y))
    assert isinstance(st, pb.BcsdLazyState)
    assert pbat.batched_attrs(m, st)["y_climo_"].shape == (2, 366)
    jst_ = jbat.batched_fit(jb.BcsdTemperature(time_grouper=DAILY, return_anoms=False), idx,
                            jnp.asarray(x)[..., None], jnp.asarray(y))
    assert isinstance(jst_, jb.BcsdLazyState)

    idx, x, y = _monthly(rng, C=6)
    m = pb.BcsdTemperature(return_anoms=False)
    xt = _t(x)[..., None]
    st_dense = pbat.batched_fit(m, idx, xt, _t(y))
    assert isinstance(st_dense, pb.BcsdState)
    out_dense = pbat.batched_predict(m, st_dense, idx, xt, idx)
    monkeypatch.setattr(pbat, "STREAMING_CELL_THRESHOLD", 4)
    st_lazy = pbat.batched_fit(m, idx, xt, _t(y))
    assert isinstance(st_lazy, pb.BcsdLazyState)
    out_lazy = pbat.batched_predict(m, st_lazy, idx, xt, idx)
    npt.assert_allclose(out_lazy.numpy(), out_dense.numpy(), rtol=0, atol=ATOL)
    npt.assert_allclose(
        pbat.batched_attrs(m, st_lazy)["y_climo_"], pbat.batched_attrs(m, st_dense)["y_climo_"],
        rtol=0, atol=ATOL,
    )


def test_jax_lazy_state_predicts_the_same_in_the_port(rng):
    idx, x, y = _daily(rng)
    idx_p, xp, _ = _daily(rng, start="2040-01-01", shift=2.0)
    pm, jm = _models("BcsdTemperature", time_grouper=DAILY, return_anoms=False)
    jfg, pfg = jm._fit_groups(idx), pm._fit_groups(idx)
    jstate = jb.bcsd_fit_lazy(jnp.asarray(x), jnp.asarray(y), jfg)
    kw = dict(variable="temperature", return_anoms=False, group_chunk=8)
    want = np.asarray(jb.bcsd_predict_streaming(jstate, jnp.asarray(xp), jm._predict_plan(jfg, idx_p), **kw))
    arrays = [np.asarray(a) for a in jstate]
    state = bcsd_lazy_state_from_jax(*arrays, device="cpu")
    for a, b in zip(bcsd_lazy_state_to_numpy(state), arrays):
        npt.assert_array_equal(a, b)
    got = pb.bcsd_predict_streaming(state, _t(xp), pm._predict_plan(pfg, idx_p), **kw).numpy()
    npt.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_interior_nan_follows_the_slide_rule(rng):
    """H1: one NaN day in y.  The port (plain K5 on the CPU) agrees with the
    JAX package's forced slide route (float32, its K1/K2/K5 in interpret
    mode): equal NaN masks, finite values within 1e-4.  The JAX package's
    default CPU route puts the NaN after the +inf pads and spreads NaN
    much further; cell 1 (no NaN) is unaffected either way."""
    idx, x, y = _daily(rng, C=2, years=3)
    x, y = x.astype(np.float32), y.astype(np.float32)
    y[0, 5] = np.nan
    pm, jm = _models("BcsdTemperature", time_grouper=DAILY, return_anoms=False)
    jfg, pfg = jm._fit_groups(idx), pm._fit_groups(idx)
    jplan = jm._predict_plan(jfg, idx)
    kw = dict(variable="temperature", return_anoms=False, group_chunk=8)
    jstate = jb.bcsd_fit_lazy(jnp.asarray(x), jnp.asarray(y), jfg)
    with rowsort.override(force=True, interpret=True):
        forced = np.asarray(jb.bcsd_predict_streaming(jstate, jnp.asarray(x), jplan, **kw))
    default = np.asarray(jb.bcsd_predict_streaming(jstate, jnp.asarray(x), jplan, **kw))
    got = pb.bcsd_predict_streaming(
        pb.bcsd_fit_lazy(_t(x), _t(y), pfg), _t(x), pm._predict_plan(pfg, idx), **kw
    ).numpy()
    assert got.dtype == np.float32
    npt.assert_array_equal(np.isnan(got), np.isnan(forced))
    npt.assert_allclose(got, forced, rtol=0, atol=1e-4)
    assert 0 < np.isnan(got[0]).sum() < np.isnan(default[0]).sum()
    assert not np.isnan(got[1]).any()
    npt.assert_allclose(got[1], default[1], rtol=0, atol=1e-4)


def test_monthly_interior_nan_follows_k2(rng):
    """F9 of ROADMAP Queue 3: one NaN month in cell 1's y (4 cells x 240
    months, ``BcsdTemperature(return_anoms=False)``, float32).  The port
    (plain K1 / K2 on the CPU) agrees with the JAX package's K2 route (its
    Pallas K1 / K2 in interpret mode): 2 NaN, at two of the February
    group's top ranks, equal masks, finite values within 1e-4.  The JAX
    default CPU route fills ties by a cummin that carries the NaN knot to
    every lower rank: the whole February group of cell 1, 20 NaN."""
    idx = pd.date_range("1980-01-01", periods=240, freq="MS")
    seas = 8 * np.sin(2 * np.pi * (idx.month.to_numpy() - 1) / 12)
    x = (284.5 + seas + rng.normal(0, 2, (4, 240))).astype(np.float32)
    y = (282.0 + seas + rng.normal(0, 1.8, (4, 240))).astype(np.float32)
    y[1, 25] = np.nan  # February 1982
    pm, jm = _models("BcsdTemperature", return_anoms=False)
    jfg, pfg = jm._fit_groups(idx), pm._fit_groups(idx)
    jplan = jm._predict_plan(jfg, idx)
    kw = dict(variable="temperature", return_anoms=False)
    default = np.asarray(jb.bcsd_predict(jb.bcsd_fit(jnp.asarray(x), jnp.asarray(y), jfg),
                                         jnp.asarray(x), jplan, **kw))
    with rowsort.override(force=True, interpret=True):
        forced = np.asarray(jb.bcsd_predict(jb.bcsd_fit(jnp.asarray(x), jnp.asarray(y), jfg),
                                            jnp.asarray(x), jplan, **kw))
    got = pb.bcsd_predict(pb.bcsd_fit(_t(x), _t(y), pfg), _t(x), pm._predict_plan(pfg, idx), **kw)
    got = got.numpy()
    assert got.dtype == np.float32
    npt.assert_array_equal(np.isnan(got), np.isnan(forced))
    npt.assert_allclose(got, forced, rtol=0, atol=1e-4)
    assert np.isnan(got).sum() == 2 and np.isnan(got[1]).sum() == 2
    feb = idx.month.to_numpy() == 2
    assert np.isnan(default).sum() == 20 and np.isnan(default[1, feb]).all()
