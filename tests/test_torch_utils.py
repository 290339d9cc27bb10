"""The port's utilities against the JAX package's on the CPU: profiling
(``utils/profiling.py``), checkpoints (``utils/checkpoint.py``), metrics
(``utils/metrics.py``) and disaggregation (``utils/disagg.py``).

Tolerances: the host label and membership tables and the checkpoint round
trips bitwise; everything else ``atol = 1e-10`` in float64 on values of
order 1-300: the same arithmetic summed in another order (the matrix
products of the resize weights and the membership pools, the metric sums).
"""

import json
import sys

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import skdownscale_tpu.utils.disagg as JD
import skdownscale_tpu.utils.metrics as JM
import skdownscale_tpu.utils.profiling as JP
from skdownscale_tpu.utils.timeindex import TimeIndex as JTI
from skdownscale_tpu.xlite import DataArray as JDA

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.utils.checkpoint as CK
import skdownscale_tpu_torch.utils.disagg as PD
import skdownscale_tpu_torch.utils.metrics as PM
import skdownscale_tpu_torch.utils.profiling as PP
from skdownscale_tpu_torch.models.quantile import qmr_fit
from skdownscale_tpu_torch.parallel.mesh import MULTI_DEVICE_ITEM
from skdownscale_tpu_torch.utils.timeindex import TimeIndex as PTI
from skdownscale_tpu_torch.xlite import DataArray as PDA

ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Drop this module's compiled JAX programs before and after it, as
    ``tests/test_torch_mbc.py`` does (one process holds every module's)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_stage_timer_report_is_the_jax_format(monkeypatch):
    """A CPU tensor needs no barrier: ``torch.cuda.synchronize`` is never
    called; the report has the JAX version's columns and order."""
    def no_sync(*a, **k):
        raise AssertionError("synchronised for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    timer, jtimer = PP.StageTimer(), JP.StageTimer()
    for name, n in (("pack", 2), ("fit", 1)):
        for _ in range(n):
            with timer.stage(name, sync={"x": (torch.ones(3), [torch.zeros(2)])}):
                pass
    timer.totals.update(pack=0.5, fit=1.25)
    jtimer.totals.update(pack=0.5, fit=1.25)
    jtimer.counts.update(pack=2, fit=1)
    assert timer.report() == jtimer.report()
    assert timer.report().splitlines()[1].startswith("fit ")


def test_trace_to_writes_a_chrome_trace_with_the_annotations(tmp_path, monkeypatch):
    """``torch.profiler`` imports ``torch._dynamo``, which looks up the spec
    of ``xarray``; the suite's stand-in module for it (``tests/conftest.py``,
    installed by the golden tests) has none, so it leaves while this runs."""
    stub = sys.modules.get("xarray")
    if stub is not None and stub.__spec__ is None:
        monkeypatch.delitem(sys.modules, "xarray")
    with PP.trace_to(str(tmp_path / "trace")) as prof:
        with PP.annotate("the-band"):
            torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(ev.get("name") == "the-band" for ev in trace["traceEvents"])
    assert any(e.key == "the-band" for e in prof.key_averages())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _fitted(rng, kind):
    if kind in ("bcsd", "arrm"):
        idx = pd.date_range("1980-01-01", periods=120, freq="MS")
        seas = 8 * np.sin(2 * np.pi * (idx.month.to_numpy() - 1) / 12)[:, None, None]
        model = (P.BcsdTemperature(return_anoms=False) if kind == "bcsd"
                 else P.PiecewiseLinearRegression(n_segments=3, fit_option="fast"))
    else:
        idx = pd.date_range("1990-01-01", periods=730, freq="D")
        seas = 10 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25)[:, None, None]
        model = P.TrendAwareQuantileMappingRegressor(P.QuantileMappingReressor(extrapolate="both"))
    x = 284.5 + seas + rng.normal(0, 2, (len(idx), 3, 5))
    y = 282.0 + seas + rng.normal(0, 1.8, (len(idx), 3, 5))
    x[:, 1, 2] = y[:, 1, 2] = np.nan
    coords = {"time": idx, "lat": np.arange(3.0), "lon": np.array(list("abcde"))}
    X, Y = (PDA(a, ("time", "lat", "lon"), coords) for a in (x, y))
    return P.PointWiseDownscaler(model, device="cpu", cell_chunk_size=8).fit(X, Y), X


def _same_tree(a, b):
    """Bitwise equal state trees: the same containers, keys and NamedTuple
    types, and tensors of the same dtype and bits."""
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["bcsd", "trend-aware", "arrm"])
def test_checkpoint_round_trip_is_bitwise(tmp_path, rng, kind):
    d, X = _fitted(rng, kind)
    path = str(tmp_path / "model.ckpt")
    CK.save(path, d)
    with np.load(path, allow_pickle=False) as z:  # no pickle anywhere in the file
        assert all(z[k].dtype != object for k in z.files)
    back = CK.load(path, device="cpu")
    assert type(back._model) is type(d._model) and back._model.get_params().keys() == d._model.get_params().keys()
    assert len(back._state) == len(d._state) == 2
    _same_tree(back._state, d._state)
    npt.assert_array_equal(back.predict(X).values, d.predict(X).values)
    if kind == "bcsd":
        npt.assert_array_equal(back.get_attr("y_climo_").values, d.get_attr("y_climo_").values)


def test_save_state_and_load_state_of_a_qmr_state(tmp_path, rng):
    st = qmr_fit(torch.from_numpy(rng.normal(size=(4, 50))),
                 torch.from_numpy(rng.normal(size=(4, 50))), extrapolate="both")
    path = str(tmp_path / "state.npz")
    CK.save_state(path, {"qmr": st, "n": 4, "names": ["a", "b"], "pair": (st.x_pp, None)})
    back = CK.load_state(path, device="cpu")
    assert type(back["qmr"]) is type(st) and back["n"] == 4 and back["names"] == ["a", "b"]
    for a, b in zip(back["qmr"], st):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert isinstance(back["pair"], tuple) and torch.equal(back["pair"][0], st.x_pp)


def _rewrite_manifest(path, edit):
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(str(arrays.pop("__manifest__")))
    edit(manifest)
    with open(path, "wb") as f:
        np.savez(f, __manifest__=np.array(json.dumps(manifest)), **arrays)


@pytest.mark.parametrize("node, name", [
    ("estimator", "skdownscale_tpu_torch.utils.zarrlite.save_array"),
    ("estimator", "skdownscale_tpu_torch.global_models.GlobalLinearRegressor"),
    ("function", "skdownscale_tpu_torch.cli.main"),
    ("namedtuple", "skdownscale_tpu_torch.utils.zarrlite.save_array"),
    ("fitted", "__class__"),
])
def test_checkpoint_refuses_names_that_a_fitted_model_does_not_hold(tmp_path, rng, monkeypatch, node, name):
    """A manifest can only build what a fitted model holds: an estimator
    node names a ``SingleCellEstimator`` subclass, a function node one of
    the groupers, a NamedTuple node a NamedTuple class, and a fitted
    attribute is a public scalar.  Nothing that a refused name points at
    is called."""
    called = []
    monkeypatch.setattr("skdownscale_tpu_torch.utils.zarrlite.save_array", lambda *a, **k: called.append(a))
    monkeypatch.setattr("skdownscale_tpu_torch.cli.main", lambda *a, **k: called.append(a))
    d, _ = _fitted(rng, "bcsd")
    path = str(tmp_path / "m.ckpt")
    CK.save(path, d)

    def edit(m):
        if node == "estimator":
            m["model"] = {"estimator": name, "params": {"store": {"value": str(tmp_path / "x")}}}
        elif node == "function":
            m["model"]["params"]["climate_trend"] = {"function": name}
        elif node == "namedtuple":
            m["state"]["list"][0] = {"namedtuple": name, "fields": [], "items": []}
        else:
            m["model_extra"][name] = {"function": "skdownscale_tpu_torch.models.groupers.PaddedDOYGrouper"}

    _rewrite_manifest(path, edit)
    with pytest.raises(ValueError, match="checkpoint"):
        CK.load(path, device="cpu")
    assert not called and not (tmp_path / "x").exists()


def test_checkpoint_refuses_to_save_a_callable_that_is_not_a_grouper(tmp_path, rng):
    d, _ = _fitted(rng, "bcsd")
    d._model.climate_trend = np.mean
    with pytest.raises(TypeError, match="only the groupers"):
        CK.save(str(tmp_path / "m.ckpt"), d)


def test_checkpoint_versions_and_devices_are_refused_with_the_jax_texts(tmp_path, rng, monkeypatch):
    path = str(tmp_path / "s.npz")
    for version, text in ((2, "has format version 2, newer than this library's 1"),
                          ("x", "has unrecognized format version 'x'")):
        with open(path, "wb") as f:
            np.savez(f, __manifest__=np.array(json.dumps({"version": version, "state": {"value": 1}})))
        with pytest.raises(ValueError, match=text):
            CK.load_state(path, device="cpu")
        with pytest.raises(ValueError, match=text):
            CK.load(path, device="cpu")
    with open(path, "wb") as f:
        np.savez(f, data=np.zeros(3))
    with pytest.raises(ValueError, match="unrecognized format version None"):
        CK.load_state(path, device="cpu")
    d, _ = _fitted(rng, "bcsd")
    CK.save(path, d)
    with pytest.raises(NotImplementedError, match=MULTI_DEVICE_ITEM):
        CK.load(path, sharding=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CK.load(path)
    with pytest.raises(ValueError, match="only batched-model"):
        CK.save(path, P.PointWiseDownscaler(P.BcsdTemperature(), device="cpu"))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _pair(rng, shape=(6, 300)):
    t = rng.normal(280, 5, shape)
    p = t + rng.normal(0.3, 2, shape)
    t[0, :10] = np.nan  # NaN in y_true
    p[1, 5:20] = np.nan  # NaN in y_pred
    p[2, 7] = np.inf
    t[3] = np.nan  # an all-NaN cell
    t[4] = np.round(t[4])  # ties across the two samples
    p[4] = np.round(p[4])
    return t, p


@pytest.mark.parametrize("name", ["rmse", "mae", "bias", "pearsonr", "r2", "ks_stat",
                                  "wet_day_freq_bias", "trend_bias"])
def test_metric_matches_jax(rng, name):
    t, p = _pair(rng)
    args = (280.0,) if name == "wet_day_freq_bias" else ()
    got = getattr(PM, name)(torch.from_numpy(t), torch.from_numpy(p), *args)
    want = getattr(JM, name)(jnp.asarray(t), jnp.asarray(p), *args)
    _close(got, want)


@pytest.mark.parametrize("q", [0.95, 0.0, 1.0, [0.01, 0.5, 0.99]])
def test_quantile_bias_matches_jax(rng, q):
    t, p = _pair(rng)
    _close(PM.quantile_bias(torch.from_numpy(t), torch.from_numpy(p), q),
           JM.quantile_bias(jnp.asarray(t), jnp.asarray(p), jnp.asarray(q)))


def test_score_all_cycle_and_energy_distance_match_jax(rng):
    t, p = _pair(rng)
    got = PM.score_all(torch.from_numpy(t), torch.from_numpy(p))
    want = JM.score_all(jnp.asarray(t), jnp.asarray(p))
    assert list(got) == list(want)
    for k in got:
        _close(got[k], want[k])
    labels = np.arange(300) % 12
    _close(PM.annual_cycle_rmse(torch.from_numpy(t), torch.from_numpy(p), labels),
           JM.annual_cycle_rmse(jnp.asarray(t), jnp.asarray(p), labels))
    x, y = rng.normal(size=(5, 40, 3)), rng.normal(0.5, 1.2, size=(5, 30, 3))
    y[2, 3, 1] = np.nan
    _close(PM.energy_distance(torch.from_numpy(x), torch.from_numpy(y)),
           JM.energy_distance(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("given", ["tensor", "arrays"])
def test_validation_report_matches_jax(rng, given):
    t, p = _pair(rng)
    preds = {"raw": p, "shifted": p - 0.3}
    y = torch.from_numpy(t) if given == "tensor" else t
    got = PM.validation_report(y, preds, quantile=0.9, wet_thresh=280.0, device="cpu")
    want = JM.validation_report(jnp.asarray(t), preds, quantile=0.9, wet_thresh=280.0)
    assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns)
    _close(got.to_numpy(), want.to_numpy())


def test_validation_report_takes_arrays_to_the_card_unless_asked(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, p = _pair(rng)
    with pytest.raises(RuntimeError, match="validation_report runs on the card.*device='cpu'"):
        PM.validation_report(t, {"raw": p})
    # a tensor stays where it is, and an array prediction follows it
    got = PM.validation_report(torch.from_numpy(t), {"raw": p})
    _close(got.to_numpy(), PM.validation_report(t, {"raw": p}, device="cpu").to_numpy(), atol=0)


# ---------------------------------------------------------------------------
# disaggregation
# ---------------------------------------------------------------------------


def test_host_tables_bitwise():
    for idx in (pd.date_range("1999-11-01", "2001-03-31", freq="D"),
                pd.date_range("1980-01-01", periods=30, freq="MS")):
        for a, b in zip(PD._month_ids(PTI.from_any(idx)), JD._month_ids(JTI.from_any(idx))):
            npt.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        labels = PD._month_ids(PTI.from_any(idx))[0]
        npt.assert_array_equal(PD._mean_matrix(labels, labels.max() + 2),
                               JD._mean_matrix(labels, labels.max() + 2))
        assert PD.daily_index_for_months(idx).equals(JD.daily_index_for_months(idx))
    src, dst = np.array([0.0, 1.5, 2.0, 4.0]), np.array([-1.0, 0.0, 0.7, 2.0, 3.99, 9.0])
    npt.assert_array_equal(PD.regrid_weights_1d(src, dst), JD.regrid_weights_1d(src, dst))
    with pytest.raises(ValueError, match="strictly increasing"):
        PD.regrid_weights_1d([0.0, 0.0, 1.0], dst)


_METHODS = ["nearest", "linear", "bilinear", "triangle", "cubic", "bicubic", "lanczos3", "lanczos5"]


@pytest.mark.parametrize("nan_aware", [False, True])
@pytest.mark.parametrize("method", _METHODS)
def test_interp_to_fine_matches_jax_image_resize(rng, method, nan_aware):
    """Upsampling, downsampling (antialiased), one axis alone, and odd
    ratios; NaN cells spread (or are renormalised away) as in JAX."""
    for src, dst in (((5, 7), (12, 17)), ((12, 17), (5, 7)), ((6, 6), (6, 13)), ((9, 4), (3, 4))):
        x = rng.normal(0, 2, (3, *src))
        x[0, 1, 1] = np.nan
        x[1, 0, :] = np.nan
        got = PD.interp_to_fine(torch.from_numpy(x), dst, method=method, nan_aware=nan_aware)
        want = JD.interp_to_fine(jnp.asarray(x), dst, method=method, nan_aware=nan_aware)
        _close(got, want)
    with pytest.raises(ValueError, match="Unknown resize method"):
        PD.interp_to_fine(torch.from_numpy(x), (4, 4), method="area")


def test_regrid_separable_matches_jax(rng):
    wy = PD.regrid_weights_1d(np.arange(5.0), np.linspace(0, 4, 11))
    wx = PD.regrid_weights_1d(np.arange(6.0) ** 1.5, np.linspace(0, 12, 9))
    x = rng.normal(size=(4, 5, 6))
    _close(PD.regrid_separable(torch.from_numpy(x), wy, wx), JD.regrid_separable(x, wy, wx))


@pytest.mark.parametrize("kind", ["temperature", "precipitation"])
@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_spatial_disaggregate_matches_jax(rng, kind, method):
    anoms = rng.normal(0, 1, (24, 4, 5))
    anoms[:, 0, 0] = np.nan
    climo = rng.uniform(1, 5, (12, 9, 11))
    labels = np.arange(24) % 12
    for nan_aware in (False, True):
        got = PD.spatial_disaggregate(anoms, climo, labels, kind=kind, method=method,
                                      nan_aware=nan_aware, device="cpu")
        want = JD.spatial_disaggregate(anoms, climo, labels, kind=kind, method=method,
                                       nan_aware=nan_aware)
        _close(got, want)
    with pytest.raises(ValueError, match="unknown kind"):
        PD.apply_climatology(torch.zeros(2, 1, 1), torch.zeros(12, 1, 1), [0, 1], kind="wind")


def _daily_obs(rng, kind, start="1999-12-01", end="2003-02-28"):
    oi = pd.date_range(start, end, freq="D")
    doy = oi.dayofyear.to_numpy()[:, None, None]
    obs = 283 + 8 * np.sin(2 * np.pi * doy / 365.25) + rng.normal(0, 2, (len(oi), 2, 3))
    if kind == "precipitation":
        obs = np.where(rng.random(obs.shape) < 0.4, 0.0, np.abs(obs - 280))
        obs[(oi.month == 7) & (oi.year == 2001)] = 0.0  # an all-dry month
    return oi, obs


@pytest.mark.parametrize("conserve", [True, False])
@pytest.mark.parametrize("kind", ["temperature", "precipitation"])
def test_temporal_disaggregate_matches_jax(rng, kind, conserve):
    mi = pd.date_range("2000-01-01", periods=36, freq="MS")
    monthly = rng.uniform(1, 10, (36, 2, 3))
    monthly[5, 0, 0] = 0.0
    oi, obs = _daily_obs(rng, kind)
    got = PD.temporal_disaggregate(monthly, mi, obs, oi, kind=kind, conserve=conserve, device="cpu")
    want = JD.temporal_disaggregate(monthly, mi, obs, oi, kind=kind, conserve=conserve)
    _close(got, want)
    # a noleap calendar for the obs: Feb 29 of the output takes the neutral pattern
    noleap = PTI.range_daily(3 * 365, start_year=2000, calendar="noleap")
    jnoleap = JTI.range_daily(3 * 365, start_year=2000, calendar="noleap")
    got = PD.temporal_disaggregate(monthly, mi, obs[:3 * 365], noleap, kind=kind,
                                   conserve=conserve, device="cpu")
    _close(got, JD.temporal_disaggregate(monthly, mi, obs[:3 * 365], jnoleap, kind=kind,
                                         conserve=conserve))
    with pytest.raises(ValueError, match="missing from monthly_index"):
        PD.temporal_disaggregate(monthly[:12], mi[:12], obs, oi,
                                 pd.date_range("2000-01-01", "2001-01-31"), device="cpu")


def test_bcsd_disaggregator_matches_jax(rng):
    mi = pd.date_range("2000-01-01", periods=36, freq="MS")
    monthly = 283 + rng.normal(0, 2, (36, 2, 3))
    oi, obs = _daily_obs(rng, "temperature")
    dims = ("time", "y", "x")
    mc = {"time": mi, "y": np.arange(2), "x": np.arange(3)}
    oc = {"time": oi, "y": np.arange(2), "x": np.arange(3)}
    got = PD.bcsd_disaggregator(PDA(monthly, dims, mc), PDA(obs, dims, oc), device="cpu")
    want = JD.bcsd_disaggregator(JDA(monthly, dims, mc), JDA(obs, dims, oc))
    assert isinstance(got, PDA) and got.dims == want.dims
    assert pd.DatetimeIndex(got.coords["time"]).equals(pd.DatetimeIndex(want.coords["time"]))
    _close(got.data, want.data)
    with pytest.raises(TypeError, match="DataArray"):
        PD.bcsd_disaggregator(monthly, obs)


def test_disaggregation_takes_the_card_unless_asked(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mi = pd.date_range("2000-01-01", periods=12, freq="MS")
    oi, obs = _daily_obs(rng, "temperature", "2000-01-01", "2000-12-31")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PD.temporal_disaggregate(rng.normal(size=(12, 2, 3)), mi, obs, oi)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PD.spatial_disaggregate(rng.normal(size=(12, 2, 3)), np.ones((12, 4, 6)), np.arange(12))
