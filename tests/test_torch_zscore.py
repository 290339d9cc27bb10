"""The port's z-score model (``models/zscore.py``), its rolling statistics
(``ops/rolling.py``) and host tables against the JAX package's on the CPU,
in float64: the (year, doy) table and the day-of-year band groups bitwise,
both forms of the windowed sum (the slice form bitwise, the banded block
form within 1e-10: F2 of ROADMAP Queue 3), the fit and predict cores, the
registry's grid (chunked and not) and the sklearn wrapper with its stats
dicts, and a JAX-fitted state carried across by ``convert.py``.

Tolerance: ``atol = 1e-10`` on values of order 1-300 K: the same float64
arithmetic summed in another order (the year pooling, the nanmean).
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import skdownscale_tpu as J
import skdownscale_tpu.models.zscore as JZ
import skdownscale_tpu.ops.rolling as JR
import skdownscale_tpu.utils.timeindex as JT
from skdownscale_tpu.xlite import DataArray as JDA

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.models.batched as PB
import skdownscale_tpu_torch.models.zscore as PZ
import skdownscale_tpu_torch.ops.rolling as PR
import skdownscale_tpu_torch.utils.timeindex as PT
from skdownscale_tpu_torch.convert import state_to_numpy, zscore_state_from_jax
from skdownscale_tpu_torch.models.base import SingleCellEstimator
from skdownscale_tpu_torch.xlite import DataArray as PDA

ATOL = 1e-10


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


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_allclose(got, want, rtol=0, atol=atol)


def _daily(rng, C, n, start="1996-01-01"):
    """(index, x, y): C daily series of 283 K + seasonal + noise and their
    observations, as bench.py:452-471."""
    idx = pd.date_range(start, periods=n, freq="D")
    seas = 10.0 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25)
    x = 283.0 + seas + rng.normal(0, 2, (C, n)) + 1.5
    y = 282.0 + seas + rng.normal(0, 1.8, (C, n))
    return idx, x, y


_INDEXES = {
    "leap-years": pd.date_range("1996-01-01", "2001-12-31", freq="D"),
    "from-march": pd.date_range("1991-03-01", periods=900, freq="D"),
    "one-year": pd.date_range("1999-01-01", periods=365, freq="D"),
    "monthly": pd.date_range("1990-01-01", periods=120, freq="MS"),
}


@pytest.mark.parametrize("name", sorted(_INDEXES))
def test_year_doy_table_bitwise(name):
    idx = _INDEXES[name]
    for a, b in zip(PZ.build_year_doy_table(idx), JZ.build_year_doy_table(idx)):
        assert a.dtype == b.dtype
        npt.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(_INDEXES))
@pytest.mark.parametrize("window", [0, 5, 15])
def test_doy_band_groups_bitwise(name, window):
    idx = _INDEXES[name]
    got = PT.doy_band_groups(PT.TimeIndex.from_pandas(idx), window)
    want = JT.doy_band_groups(JT.TimeIndex.from_pandas(idx), window)
    for field in ("indices", "mask", "counts", "keys"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        npt.assert_array_equal(a, b)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("window", [1, 9, 10, 31])
def test_window_sum_slice_form_bitwise(rng, center, window):
    """The slice form adds taps in ascending window offset, as the JAX form
    does, so the bits agree (NaN included)."""
    x = rng.normal(283.0, 3.0, (4, 700))
    x[1, 30] = np.nan
    got = PR._window_sum(torch.from_numpy(x), window, center).numpy()
    want = np.asarray(JR._window_sum(jnp.asarray(x), window, center))
    npt.assert_array_equal(got, want)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("window", [9, 31, 129])
def test_window_sums_banded_form_matches_jax(rng, center, window):
    """The banded block form (two (B, B) band products a block) against the
    JAX ``_window_sums_matmul``, which runs on the CPU when called
    directly, and against the slice form."""
    x = rng.normal(0.0, 3.0, (3, 1000))
    got = PR._window_sums_matmul(torch.from_numpy(x), window, center)
    _close(got, np.asarray(JR._window_sums_matmul(jnp.asarray(x), 1000, window, center)))
    _close(got, PR._window_sum(torch.from_numpy(x), window, center))


def test_rolling_sum_count_mean_std_match_jax(rng):
    x = rng.normal(283.0, 3.0, (3, 400))
    valid = rng.random((3, 400)) > 0.1
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    for v_p, v_j in ((None, None), (vt, jnp.asarray(valid))):
        for a, b in zip(PR.rolling_sum_count(xt, v_p, 31), JR.rolling_sum_count(jnp.asarray(x), v_j, 31)):
            npt.assert_array_equal(a.numpy(), np.asarray(b))
        for mp in (None, 1, 20):
            _close(PR.rolling_mean(xt, 31, min_periods=mp, valid=v_p),
                   JR.rolling_mean(jnp.asarray(x), 31, min_periods=mp, valid=v_j))
            _close(PR.rolling_std(xt, 31, min_periods=mp, valid=v_p),
                   JR.rolling_std(jnp.asarray(x), 31, min_periods=mp, valid=v_j))


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("ddof,mp", [(1, None), (0, 5)])
def test_rolling_mean_std_both_forms_match_jax(rng, monkeypatch, banded, ddof, mp):
    """Both forms of ``rolling_mean_std`` (the banded one forced on the CPU,
    where the gate sends float64 to the slice form) against the same form
    of the JAX package, with a NaN poisoning its windows (F2)."""
    x = rng.normal(283.0, 3.0, (3, 700))
    x[2, 100] = np.nan
    monkeypatch.setattr(PR, "use_stats_matmul", lambda t, w: banded)
    monkeypatch.setattr(JR, "_STATS_MATMUL_OVERRIDE", banded)
    got = PR.rolling_mean_std(torch.from_numpy(x), 31, ddof=ddof, min_periods=mp)
    want = JR.rolling_mean_std(jnp.asarray(x), 31, ddof=ddof, min_periods=mp)
    for a, b in zip(got, want):
        _close(a, b)


def test_stats_gate_takes_the_banded_form_only_on_cuda_float32():
    long = torch.zeros((2, 4 * 128))
    assert not PR.use_stats_matmul(long, 31)  # CPU float32
    assert not PR.use_stats_matmul(long.double(), 31)


@pytest.mark.parametrize("window", [31, 15, 4])
def test_zscore_cores_match_jax(rng, window):
    idx, x, y = _daily(rng, 3, 1500)
    tab, mask = JZ.build_year_doy_table(idx)
    inds = JZ.expand_indices(1500)
    for c in range(3):
        js = JZ.zscore_fit(jnp.asarray(x[c]), jnp.asarray(y[c]), jnp.asarray(tab), jnp.asarray(mask),
                           window=window)
        ps = PZ.zscore_fit(torch.from_numpy(x[c]), torch.from_numpy(y[c]), tab, mask, window=window)
        for a, b in zip(ps, js):
            _close(a, b)
        for a, b in zip(PZ.zscore_predict(ps, torch.from_numpy(x[c]), inds, window=window),
                        JZ.zscore_predict(js, jnp.asarray(x[c]), jnp.asarray(inds), window=window)):
            _close(a, b)


@pytest.mark.parametrize("n", [100, 364, 365, 1000, 7305])
def test_expand_indices_bitwise(n):
    got, want = PZ.expand_indices(n), JZ.expand_indices(n)
    assert got.dtype == want.dtype
    npt.assert_array_equal(got, want)


def test_float32_fit_centres_before_squaring(rng):
    """In float32 the fit's statistics stay within float32 rounding of the
    float64 ones (centring kills the cancellation of raw ~283 K squares)."""
    idx, x, y = _daily(rng, 2, 3650)
    tab, mask = PZ.build_year_doy_table(idx)
    s64 = PZ.zscore_fit(torch.from_numpy(x), torch.from_numpy(y), tab, mask)
    s32 = PZ.zscore_fit(torch.from_numpy(x).float(), torch.from_numpy(y).float(), tab, mask)
    assert float((s32.x_std.double() - s64.x_std).abs().max()) < 2e-4
    assert float((s32.x_mean.double() - s64.x_mean).abs().max()) < 2e-4


def _grid(rng, C=30, n=1200):
    idx, x, y = _daily(rng, C, n)
    x, y = x.T.copy(), y.T.copy()
    x[:, [0, 7]] = np.nan  # NaN cells
    y[:, [0, 7]] = np.nan
    return ("time", "cell"), {"time": idx, "cell": np.arange(C)}, x, y


@pytest.mark.parametrize("pass_elements", [None, 5_000])
def test_registry_grid_matches_jax(rng, monkeypatch, pass_elements):
    """``PointWiseDownscaler(ZScoreRegressor())`` on a grid with NaN cells,
    in two runner chunks, and with the registry's passes cut to 4 cells."""
    if pass_elements is not None:
        monkeypatch.setattr(PB, "ZSCORE_PASS_ELEMENTS", pass_elements)
    dims, c, x, y = _grid(rng)
    j = J.PointWiseDownscaler(J.ZScoreRegressor(window_width=21)).fit(JDA(x, dims, c), JDA(y, dims, c))
    p = P.PointWiseDownscaler(P.ZScoreRegressor(window_width=21), device="cpu", cell_chunk_size=17)
    p.fit(PDA(x, dims, c), PDA(y, dims, c))
    got = p.predict(PDA(x, dims, c))
    assert got.dims == dims and got.values.dtype == np.float64
    _close(got.values, j.predict(JDA(x, dims, c)).values)
    for key in ("shift_", "scale_"):
        _close(p.get_attr(key).values, j.get_attr(key).values)


def test_wrapper_matches_jax_with_stats_dicts(rng):
    idx, x, y = _daily(rng, 1, 1500)
    X = pd.DataFrame({"t": x[0]}, index=idx)
    Y = pd.DataFrame({"t": y[0]}, index=idx)
    jm, pm = J.ZScoreRegressor().fit(X, Y), P.ZScoreRegressor().fit(X, Y)
    _close(pm.shift_, jm.shift_)
    _close(pm.scale_, jm.scale_)
    for k, v in jm.fit_stats_dict_.items():
        assert isinstance(pm.fit_stats_dict_[k], pd.Series)
        assert pm.fit_stats_dict_[k].index.equals(v.index)
        _close(pm.fit_stats_dict_[k].to_numpy(), v.to_numpy())
    got, want = pm.predict(X), jm.predict(X)
    assert isinstance(got, pd.DataFrame) and got.index.equals(want.index)
    assert list(got.columns) == list(want.columns)
    _close(got.to_numpy(), want.to_numpy())
    for k, v in jm.predict_stats_dict_.items():
        assert pm.predict_stats_dict_[k].index.equals(v.index)
        _close(pm.predict_stats_dict_[k].to_numpy(), v.to_numpy())


def test_wrapper_on_arrays_makes_up_a_monthly_index(rng):
    """Bare arrays: the made-up index (freq ``_timestep = "MS"``) and its
    warning, a (n, 1) prediction and array stats, as the JAX wrapper."""
    _, x, y = _daily(rng, 1, 240)
    with pytest.warns(UserWarning, match="making one up"):
        pm = P.ZScoreRegressor(window_width=5).fit(x[0], y[0])
    with pytest.warns(UserWarning, match="making one up"):
        jm = J.ZScoreRegressor(window_width=5).fit(x[0], y[0])
    got, want = pm.predict(x[0]), jm.predict(x[0])
    assert got.shape == want.shape == (240, 1)
    _close(got, want)
    assert set(pm.predict_stats_dict_) == set(jm.predict_stats_dict_)
    with pytest.raises(ValueError, match="window_width"):
        P.ZScoreRegressor(window_width=0).fit(x[0], y[0])
    with pytest.raises(ValueError, match="1 feature"):
        P.ZScoreRegressor().fit(np.stack([x[0], x[0]], 1), y[0])


def test_jax_fitted_state_predicts_the_same_in_the_port(rng):
    idx, x, y = _daily(rng, 4, 1100)
    tab, mask = JZ.build_year_doy_table(idx)
    jstate = jax.vmap(lambda a, b: JZ.zscore_fit(a, b, jnp.asarray(tab), jnp.asarray(mask)))(
        jnp.asarray(x), jnp.asarray(y))
    arrays = [np.asarray(a) for a in jstate]
    state = zscore_state_from_jax(*arrays, device="cpu")
    for a, b in zip(state_to_numpy(state), arrays):
        npt.assert_array_equal(a, b)
    inds = JZ.expand_indices(1100)
    want = jax.vmap(lambda s, xx: JZ.zscore_predict(s, xx, jnp.asarray(inds))[0])(jstate, jnp.asarray(x))
    _close(PZ.zscore_predict(state, torch.from_numpy(x), inds)[0], want)
