"""The port's CUDA kernels and its grid path on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor skdownscale_tpu, so it also runs where JAX is not
installed; on a machine with a card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import skdownscale_tpu_torch as P
from skdownscale_tpu_torch.kernels import rank_map as K
from skdownscale_tpu_torch.kernels import slide_sort as S
from skdownscale_tpu_torch.models import bcsd as B
from skdownscale_tpu_torch.models.slide import build_slide_plan
from skdownscale_tpu_torch.utils.timeindex import TimeIndex, padded_doy_groups
from skdownscale_tpu_torch.xlite import DataArray


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _adversarial(rng, rows, L):
    """float32 rows with NaN, -NaN, +-0, +-inf, heavy ties and equal rows."""
    x = rng.normal(0, 50, (rows, L)).astype(np.float32)
    flat = x.reshape(-1)
    for value in (np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0):
        flat[rng.integers(0, flat.size, max(1, flat.size // 200))] = value
    x[::4] = np.round(x[::4] / 50) * 50
    x[1::17] = 7.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,G,L", [(2048, 12, 40), (512, 1, 7), (512, 1, 31), (300, 3, 100), (256, 1, 256), (8, 1, 4000)]
)
def test_kernels_bitwise_vs_plain(cuda_device, rng, B, G, L):
    x = torch.from_numpy(_adversarial(rng, B * G, L).reshape(B, G * L)).to(cuda_device)
    res = torch.from_numpy(
        np.sort(rng.normal(0, 1, (B * G, L)).astype(np.float32), axis=1).reshape(B, G * L)
    ).to(cuda_device)
    n0 = dict(K.LAUNCHES)
    if L <= K.COUNT_SORT_MAX_LEN:
        got1 = K.count_sort_segments(x, L)
        want1 = K.count_sort_segments_plain(x, L)
    got2 = K.rank_map_segments(x, res, L)
    torch.cuda.synchronize()
    want2 = K.rank_map_segments_plain(x, res, L)
    if L <= K.COUNT_SORT_MAX_LEN:
        assert K.LAUNCHES["count_sort_segments"] == n0.get("count_sort_segments", 0) + 1
        assert torch.equal(got1.view(torch.int32), want1.view(torch.int32))
    assert K.LAUNCHES["rank_map_segments"] == n0.get("rank_map_segments", 0) + 1
    assert torch.equal(got2.view(torch.int32), want2.view(torch.int32))


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x64 = torch.zeros((2, 40), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        K.count_sort_segments(x64, 40)
    with pytest.raises(TypeError):
        K.rank_map_segments(x64, x64, 40)
    x = torch.zeros((2, 600), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError):
        K.count_sort_segments(x, 300)  # longer than K1 takes
    with pytest.raises(ValueError):
        K.rank_map_segments(x[:, ::2], x[:, ::2], 30)  # not contiguous


@pytest.mark.cuda
def test_pointwise_on_cuda_matches_cpu_float64(cuda_device, rng):
    """float32 on the card against the port's float64 CPU path.  Rounding
    at ~290 K is ~3e-5 K, so the bulk agrees within 1e-3 K; a float32
    near-tie may swap two ranks and move that query by one step of its
    fitted CDF, so at most 0.1% of values may exceed that, by at most 5 K."""
    T, C = 480, 512
    idx = pd.date_range("1970-01-01", periods=T, freq="MS")
    seas = (8 * np.sin(2 * np.pi * (idx.month.values - 1) / 12))[:, None]
    x = (283 + seas + rng.normal(0, 2, (T, C)) + 1.5).astype(np.float32)
    y = (282 + seas + rng.normal(0, 1.8, (T, C))).astype(np.float32)
    x[:, [0, 7, 100]] = np.nan
    coords = {"time": idx, "cell": np.arange(C)}
    dims = ("time", "cell")

    def run(device, a, b):
        m = P.PointWiseDownscaler(P.BcsdTemperature(return_anoms=False), device=device)
        out = m.fit(DataArray(a, dims, coords), DataArray(b, dims, coords)).predict(
            DataArray(a, dims, coords)
        )
        return out.values, m.get_attr("y_climo_").values

    n0 = dict(K.LAUNCHES)
    got, climo = run(cuda_device, x, y)
    for name in ("count_sort_segments", "rank_map_segments"):
        assert K.LAUNCHES[name] > n0.get(name, 0)
    want, want_climo = run("cpu", x.astype(np.float64), y.astype(np.float64))
    assert got.dtype == np.float32
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    d = np.abs(got.astype(np.float64) - want)[~np.isnan(want)]
    assert np.quantile(d, 0.999) <= 1e-3
    assert np.mean(d > 1e-3) <= 1e-3 and d.max() <= 5.0
    npt.assert_allclose(climo, want_climo, rtol=0, atol=1e-3)


def _slide_cases():
    """(name, TimeIndex): leap years, a noleap calendar, partial windows."""
    return [
        ("standard_6y", TimeIndex.from_pandas(pd.date_range("1999-01-01", periods=6 * 365 + 2, freq="D"))),
        ("noleap_10y", TimeIndex.range_daily(3650, calendar="noleap")),
        ("short", TimeIndex.from_pandas(pd.date_range("2003-01-20", periods=400, freq="D"))),
    ]


@pytest.mark.cuda
def test_slide_kernel_bitwise_vs_plain(cuda_device, rng):
    """K5 on the card against its plain version: ties and +-0 (H2),
    clustered inserts (H3), calendars (H4), all-NaN and interior-NaN cells
    (H5, H1), and the NaN whose key equals the pad key."""
    for name, ti in _slide_cases():
        plan = build_slide_plan(padded_doy_groups(ti), np.arange(31))
        T = len(ti)
        y = _adversarial(rng, 64, T)
        y[3] = np.nan
        doy = ti.dayofyear
        y[4] = np.where(doy % 2 == 0, -100.0, 100.0)
        y[4, doy >= 17] = rng.normal(0, 0.5, int((doy >= 17).sum()))
        y[5, ::9] = np.frombuffer(np.int32(0x7FFFFFFF).tobytes(), np.float32)[0]
        yd = torch.from_numpy(y).to(cuda_device)
        n_rows = len(plan.consulted) + 1
        n0 = K.LAUNCHES["slide_sorted_windows"]
        got = S.slide_sorted_windows(yd, plan, n_rows=n_rows)
        torch.cuda.synchronize()
        assert K.LAUNCHES["slide_sorted_windows"] == n0 + 1
        want = S.slide_sorted_windows_plain(yd, plan, n_rows=n_rows)
        assert got.shape == (64, n_rows * plan.Lto)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name


@pytest.mark.cuda
def test_slide_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    ti = TimeIndex.range_daily(800)
    plan = build_slide_plan(padded_doy_groups(ti), np.arange(31))
    with pytest.raises(TypeError):
        S.slide_sorted_windows(torch.zeros((2, 800), dtype=torch.float64, device=cuda_device), plan)
    with pytest.raises(ValueError):
        S.slide_sorted_windows(torch.zeros((2, 1600), device=cuda_device)[:, ::2], plan)


def _daily_grid(rng, T, C):
    idx = pd.date_range("1990-01-01", periods=T, freq="D")
    seas = (10 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25))[:, None]
    x = (283 + seas + rng.normal(0, 2, (T, C)) + 1.5).astype(np.float32)
    y = (282 + seas + rng.normal(0, 1.8, (T, C))).astype(np.float32)
    x[:, [0, 7, 100]] = np.nan
    return idx, x, y


@pytest.mark.cuda
def test_daily_pointwise_on_cuda_matches_cpu_float64(cuda_device, rng):
    """Daily BCSD, float32 on the card against the float64 CPU path, with
    the tolerance of the monthly test above."""
    idx, x, y = _daily_grid(rng, 4 * 365 + 1, 256)
    coords, dims = {"time": idx, "cell": np.arange(256)}, ("time", "cell")

    def run(device, a, b):
        m = P.PointWiseDownscaler(
            P.BcsdTemperature(time_grouper="daily_nasa-nex", return_anoms=False), device=device
        )
        out = m.fit(DataArray(a, dims, coords), DataArray(b, dims, coords)).predict(
            DataArray(a, dims, coords)
        )
        return out.values, m.get_attr("y_climo_").values

    n0 = dict(K.LAUNCHES)
    got, climo = run(cuda_device, x, y)
    for name in ("slide_sorted_windows", "rank_map_segments"):
        assert K.LAUNCHES[name] > n0.get(name, 0), name
    want, want_climo = run("cpu", x.astype(np.float64), y.astype(np.float64))
    assert got.dtype == np.float32 and climo.shape == (366, 256)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    d = np.abs(got.astype(np.float64) - want)[~np.isnan(want)]
    assert np.quantile(d, 0.999) <= 1e-3
    assert np.mean(d > 1e-3) <= 1e-3 and d.max() <= 5.0
    npt.assert_allclose(climo, want_climo, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_monthly_streaming_on_cuda_matches_dense(cuda_device, rng):
    T, C = 480, 512
    idx = pd.date_range("1970-01-01", periods=T, freq="MS")
    seas = 8 * np.sin(2 * np.pi * (idx.month.values - 1) / 12)
    x = torch.from_numpy((283 + seas + rng.normal(0, 2, (C, T)) + 1.5).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy((282 + seas + rng.normal(0, 1.8, (C, T))).astype(np.float32)).to(cuda_device)
    m = B.BcsdTemperature(return_anoms=False)
    fg = m._fit_groups(idx)
    plan = m._predict_plan(fg, idx)
    dense = B.bcsd_predict(B.bcsd_fit(x, y, fg), x, plan, return_anoms=False)
    n0 = dict(K.LAUNCHES)
    got = B.bcsd_predict_streaming(B.bcsd_fit_lazy(x, y, fg), x, plan, return_anoms=False, group_chunk=3)
    torch.cuda.synchronize()
    for name in ("count_sort_segments", "rank_map_segments"):
        assert K.LAUNCHES[name] >= n0.get(name, 0) + 4, name  # once per chunk
    d = (got.double() - dense.double()).abs().cpu().numpy()
    assert np.quantile(d, 0.999) <= 1e-3 and d.max() <= 5.0
