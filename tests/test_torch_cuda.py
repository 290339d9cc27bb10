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
from skdownscale_tpu_torch.utils.timeindex import PaddedGroups, TimeIndex, padded_doy_groups
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
@pytest.mark.parametrize(
    "B,G,L",
    [(700, 1, 1), (300, 4, 64), (300, 4, 65), (300, 2, 256), (300, 2, 257), (64, 1, 1024),
     (64, 1, 1025), (16, 1, 16384), (16, 1, 16385), (300, 1, 55_152)],
)
def test_kernels_bitwise_vs_plain_at_every_route_and_any_length(cuda_device, rng, B, G, L):
    """K1 and K2 on each side of every route edge of csrc/rank_map.cu, and
    K2 with one daily series of 1950-01-01 to 2100-12-31 a row (L = 55,152,
    the search route; the kernel raised there before it had one): bitwise
    equal to the plain versions, one launch a call, the build's route the
    one kernels/rank_map.route names."""
    x = torch.from_numpy(_adversarial(rng, B * G, L).reshape(B, G * L)).to(cuda_device)
    res = torch.from_numpy(
        np.sort(rng.normal(0, 1, (B * G, L)).astype(np.float32), axis=1).reshape(B, G * L)
    ).to(cuda_device)
    kernels = ["rank_map_segments"] + (["count_sort_segments"] if L <= K.COUNT_SORT_MAX_LEN else [])
    for name in kernels:
        assert K.launch_geometry(name, L)["route"] == K.route(name, L)
        n0 = K.LAUNCHES[name]
        if name == "count_sort_segments":
            got, want = K.count_sort_segments(x, L), K.count_sort_segments_plain(x, L)
        else:
            got, want = K.rank_map_segments(x, res, L), K.rank_map_segments_plain(x, res, L)
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == n0 + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name


@pytest.mark.cuda
def test_quantile_mapper_on_a_1950_2100_daily_grid_on_the_card(cuda_device, rng):
    """QuantileMapper(detrend=True) fit + transform of 16 cells of daily
    data from 1950-01-01 to 2100-12-31 (K2 at L = 55,152) on the card
    against the CPU float64 path, within the quantile family's limits."""
    index = pd.date_range("1950-01-01", "2100-12-31", freq="D")
    T, C = len(index), 16
    seas = 10 * np.sin(2 * np.pi * (index.dayofyear.values - 1) / 365.25)
    x = (283 + seas[:, None] + np.linspace(0, 3, T)[:, None] + rng.normal(0, 2, (T, C))).astype(np.float32)
    x[:, 5] = np.nan
    coords = {"time": index, "cell": np.arange(C)}
    dims = ("time", "cell")
    n0 = K.LAUNCHES["rank_map_segments"]
    got = P.PointWiseDownscaler(P.QuantileMapper(detrend=True), device=cuda_device).fit(
        DataArray(x, dims, coords)).transform(DataArray(x, dims, coords)).values
    assert K.LAUNCHES["rank_map_segments"] > n0
    x64 = DataArray(x.astype(np.float64), dims, coords)
    want = P.PointWiseDownscaler(P.QuantileMapper(detrend=True), device="cpu").fit(x64).transform(x64).values
    assert got.dtype == np.float32 and got.shape == want.shape and got.size == T * C
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    d = np.abs(got.astype(np.float64) - want)[~np.isnan(want)]
    assert np.quantile(d, 0.999) <= 2e-3
    assert np.mean(d > 1e-3) <= 5e-3 and d.max() <= 5.0


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


def _sliding_groups(width, shift, n_groups):
    """Fit groups of ``width`` members, each ``shift`` steps after the one
    before: a plan whose buckets hold ``shift`` members."""
    members = [np.arange(g * shift, g * shift + width) for g in range(n_groups)]
    T = (n_groups - 1) * shift + width
    return PaddedGroups.from_member_lists(members, np.arange(n_groups)), T


def _long_slide_plans():
    """(name, plan, T): daily plans of 33, 50 and 100 years (BW 40, 56, 104;
    Wp 1,064 to 3,208, so window 0 takes the block sort; Lto 1,024, 1,552
    and 3,104), and a plan of 8,200-member windows (Wp above 8,192)."""
    out = []
    for years in (33, 50, 100):
        ti = TimeIndex.from_pandas(pd.date_range("1950-01-01", periods=int(years * 365.25), freq="D"))
        out.append((f"{years}y", build_slide_plan(padded_doy_groups(ti), np.arange(31), max_bucket=128), len(ti)))
    groups, T = _sliding_groups(8200, 100, 6)
    out.append(("wide", build_slide_plan(groups, np.arange(6), max_bucket=128), T))
    return out


@pytest.mark.cuda
def test_slide_kernel_long_plans_bitwise_vs_plain(cuda_device, rng):
    """K5 where window 0 is too long for the warp sort and the buckets take
    two or four keys a lane, with rows past the last window (n_rows >
    n_windows): bitwise against the plain version, one launch each."""
    for name, plan, T in _long_slide_plans():
        assert plan.add_idx.shape[1] > 32 and len(plan.w0_idx) > 1024 and plan.Lto >= 1024, name
        assert S.launch_geometry(plan)["block_route"] == 1, name
        y = _adversarial(rng, 6, T)
        y[2] = np.nan
        y[3, ::7] = np.frombuffer(np.int32(0x7FFFFFFF).tobytes(), np.float32)[0]
        yd = torch.from_numpy(y).to(cuda_device)
        n_rows = len(plan.consulted) + 3
        n0 = K.LAUNCHES["slide_sorted_windows"]
        got = S.slide_sorted_windows(yd, plan, n_rows=n_rows)
        torch.cuda.synchronize()
        assert K.LAUNCHES["slide_sorted_windows"] == n0 + 1
        want = S.slide_sorted_windows_plain(yd, plan, n_rows=n_rows)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name


@pytest.mark.cuda
def test_slide_kernel_takes_a_warp_a_cell_up_to_1024(cuda_device):
    ti = TimeIndex.from_pandas(pd.date_range("1990-01-01", periods=7305, freq="D"))
    g = S.launch_geometry(build_slide_plan(padded_doy_groups(ti), np.arange(31)))
    assert g["block_route"] == 0 and g["cells_per_block"] == g["threads"] // 32 and g["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_slide_kernel_raises_on_plans_it_does_not_take(cuda_device):
    """Buckets above 128 members or windows above 16,384 slots: the launch
    is refused, nothing is counted."""
    for width, shift in ((300, 200), (16400, 8)):
        groups, T = _sliding_groups(width, shift, 3)
        plan = build_slide_plan(groups, np.arange(3), max_bucket=256)
        n0 = K.LAUNCHES["slide_sorted_windows"]
        with pytest.raises(RuntimeError, match="slide_sorted_windows"):
            S.slide_sorted_windows(torch.zeros((2, T), device=cuda_device), plan)
        assert K.LAUNCHES["slide_sorted_windows"] == n0


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


# ----------------------------------------------------------------------
# K6 and the quantile family
# ----------------------------------------------------------------------


def _interp_case(rng, B, L, Q, pad=True, sentinels=False, nan_rows=False):
    """float32 monotone tables with ties, +inf pads, +-1e20 sentinels and NaN
    knot rows; queries with knot hits, both ends, NaN and +-inf."""
    xp = np.sort(np.round(rng.normal(0, 5, (B, L)) * 2) / 2, axis=1)
    fp = np.maximum.accumulate(np.cumsum(rng.uniform(0, 1, (B, L)), axis=1), axis=1)
    if sentinels:
        xp[:, 0], xp[:, -1] = -1e20, 1e20
        fp[:, 0], fp[:, -1] = fp[:, 1] - 3e22, fp[:, -2] + 3e22
    if pad:
        n_valid = rng.integers(max(2, L // 2), L + 1, B)
        valid = np.arange(L)[None, :] < n_valid[:, None]
        xp = np.where(valid, xp, np.inf)
        fp = np.where(valid, fp, np.take_along_axis(fp, (n_valid - 1)[:, None], axis=1))
    if nan_rows:
        xp[1::13, L // 3] = np.nan
        fp[2::13, L // 2] = np.nan
    fin = np.where(np.isfinite(xp), xp, np.nan)
    lo, hi = np.nanmin(fin, axis=1)[:, None], np.nanmax(fin, axis=1)[:, None]
    q = rng.uniform(lo - 3, hi + 3, (B, Q))
    knots = np.take_along_axis(xp, rng.integers(0, L, (B, Q)), axis=1)
    q = np.where((rng.random((B, Q)) < 0.2) & np.isfinite(knots), knots, q)
    q[:, 0], q[:, 1] = lo[:, 0] - 10, hi[:, 0] + 10
    q[::5, 2], q[::7, 3], q[::11, 4] = np.nan, np.inf, -np.inf
    return [np.ascontiguousarray(a, dtype=np.float32) for a in (xp, fp, q)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,L,Q,kw",
    [(512, 42, 40, {}), (300, 1462, 732, {"sentinels": True, "pad": False}),
     (256, 1462, 732, {"nan_rows": True}), (64, 7307, 3654, {"sentinels": True}),
     (1000, 3, 300, {})],
)
@pytest.mark.parametrize("shared", [None, "xp", "fp", "q"])
def test_interp_kernel_bitwise_vs_plain(cuda_device, rng, B, L, Q, kw, shared):
    from skdownscale_tpu_torch.kernels import interp as I

    xp, fp, q = _interp_case(rng, B, L, Q, **kw)
    args = {"xp": xp, "fp": fp, "q": q}
    if shared:
        args[shared] = args[shared][:1]
    t = [torch.from_numpy(args[k]).to(cuda_device) for k in ("xp", "fp", "q")]
    n0 = I.LAUNCHES["batched_interp"]
    got = I.batched_interp(*t)
    torch.cuda.synchronize()
    assert I.LAUNCHES["batched_interp"] == n0 + 1
    want = I.batched_interp_plain(*t)
    assert got.shape == (B, Q)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _interp_tensors(rng, B, L, Q, shared, dev, offset=0, **kw):
    """K6's arguments on the card, each with ``shared`` of them one row;
    ``offset`` elements before every row table, so that rows start off
    their 16-byte lines."""
    xp, fp, q = _interp_case(rng, B, L, Q, **kw)
    args = {"xp": xp, "fp": fp, "q": q}
    for name in shared:
        args[name] = args[name][:1]
    out = []
    for name in ("xp", "fp", "q"):
        a = np.ascontiguousarray(args[name])
        flat = torch.zeros(offset + a.size, device=dev)
        flat[offset:] = torch.from_numpy(a.reshape(-1)).to(dev)
        out.append(flat[offset:].view(a.shape))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shared", [(), ("xp",), ("fp",), ("q",), ("xp", "fp"), ("xp", "q"), ("fp", "q"), ("xp", "fp", "q")]
)
def test_interp_kernel_persistent_grid_with_every_shared_argument(cuda_device, rng, shared):
    """Every combination of stride-0 arguments, with rows that start 4 bytes
    past a 16-byte line.  Where a table is per row, the rows are staged on
    the persistent grid, with more rows than resident blocks (each block
    walks several rows through both buffers); with both tables shared
    nothing is staged a row and the kernel takes the device-memory route."""
    from skdownscale_tpu_torch.kernels import interp as I

    t = _interp_tensors(rng, 3000, 5000, 700, shared, cuda_device, offset=1, nan_rows=True)
    g = I.launch_geometry(*t)
    rows = max(a.shape[0] for a in t)
    staged = not ("xp" in shared and "fp" in shared)
    assert g["staged"] == staged and (not staged or g["grid"] < rows), g
    n0 = I.LAUNCHES["batched_interp"]
    got = I.batched_interp(*t)
    torch.cuda.synchronize()
    assert I.LAUNCHES["batched_interp"] == n0 + 1
    want = I.batched_interp_plain(*t)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,L,Q,staged", [(3, 40_000, 500, 0), (5, 14_000, 300, 1), (7, 3650, 732, 1), (7, 1462, 732, 0)]
)
def test_interp_kernel_long_rows_and_fewer_rows_than_blocks(cuda_device, rng, B, L, Q, staged):
    """Rows too long to stage twice keep the route through device memory,
    and so do rows short enough for L1 to hold those of every resident
    block; a staged grid of fewer rows than resident blocks takes one block
    a row."""
    from skdownscale_tpu_torch.kernels import interp as I

    t = _interp_tensors(rng, B, L, Q, (), cuda_device, offset=3, nan_rows=True)
    g = I.launch_geometry(*t)
    assert g["staged"] == staged and (not staged or g["grid"] == B), g
    n0 = I.LAUNCHES["batched_interp"]
    got = I.batched_interp(*t)
    torch.cuda.synchronize()
    assert I.LAUNCHES["batched_interp"] == n0 + 1
    assert torch.equal(got.view(torch.int32), I.batched_interp_plain(*t).view(torch.int32))


@pytest.mark.cuda
def test_interp_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    from skdownscale_tpu_torch.kernels import interp as I

    x = torch.zeros((4, 10), device=cuda_device)
    with pytest.raises(TypeError):
        I.batched_interp(x.double(), x.double(), x.double())
    with pytest.raises(ValueError):  # tensors on two devices
        I.batched_interp(x.cpu(), x, x)
    with pytest.raises(ValueError):  # not contiguous
        I.batched_interp(x[:, ::2], x[:, ::2], x)
    with pytest.raises(ValueError):  # row counts that do not broadcast
        I.batched_interp(x, x, torch.zeros((3, 10), device=cuda_device))


def _config9_grid(rng, C, T_fit=1460, T_pred=730):
    idx = pd.date_range("1990-01-01", periods=T_fit, freq="D")
    idx_p = pd.date_range("2050-01-01", periods=T_pred, freq="D")
    seas = 10.0 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25)
    seas_p = 10.0 * np.sin(2 * np.pi * (idx_p.dayofyear.to_numpy() - 1) / 365.25)
    x = (283.0 + seas[:, None] + rng.normal(0, 2, (T_fit, C)) + 1.5).astype(np.float32)
    y = (282.0 + seas[:, None] + rng.normal(0, 1.8, (T_fit, C))).astype(np.float32)
    xq = (283.6 + seas_p[:, None] + rng.normal(0, 2, (T_pred, C))).astype(np.float32)
    for a in (x, y, xq):
        a[:, [0, 7, 100]] = np.nan
    dims = ("time", "cell")
    return dims, {"time": idx, "cell": np.arange(C)}, {"time": idx_p, "cell": np.arange(C)}, x, y, xq


@pytest.mark.cuda
def test_config9b_pointwise_on_cuda_matches_cpu_float64(cuda_device, rng):
    """TrendAware(QMR(extrapolate="both")) on the card against the port's
    float64 CPU path; K6 runs twice per predict chunk.  Detrending in
    float32 perturbs a series by about its float32 spacing at ~283 K, which
    the piecewise-linear map can move by up to one y-CDF step where two x
    knots nearly tie: 99.9% within 2e-3 K, at most 0.5% above 1e-3 K, none
    above 5 K (chip_smoke.py's quantile tolerance)."""
    dims, c_fit, c_pred, x, y, xq = _config9_grid(rng, 384)

    def run(device, a, b, q):
        m = P.PointWiseDownscaler(
            P.TrendAwareQuantileMappingRegressor(P.QuantileMappingReressor(extrapolate="both")),
            device=device, cell_chunk_size=200,
        )
        m.fit(DataArray(a, dims, c_fit), DataArray(b, dims, c_fit))
        return m.predict(DataArray(q, dims, c_pred)).values

    got = run(cuda_device, x, y, xq)  # warm-up builds the kernel
    n0 = K.LAUNCHES["batched_interp"]
    got = run(cuda_device, x, y, xq)
    assert K.LAUNCHES["batched_interp"] - n0 >= 2 * 2  # two per predict, two chunks
    want = run("cpu", x.astype(np.float64), y.astype(np.float64), xq.astype(np.float64))
    assert got.dtype == np.float32 and got.shape == (730, 384)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    d = np.abs(got.astype(np.float64) - want)[~np.isnan(want)]
    assert np.quantile(d, 0.999) <= 2e-3
    assert np.mean(d > 1e-3) <= 5e-3 and d.max() <= 5.0


@pytest.mark.cuda
def test_quantile_mapper_grid_launches_k2_and_single_cell_runs_on_the_card(cuda_device, rng):
    dims, c_fit, c_pred, x, _, xq = _config9_grid(rng, 128)
    n0 = K.LAUNCHES["rank_map_segments"]
    m = P.PointWiseDownscaler(P.QuantileMapper(detrend=True), device=cuda_device)
    got = m.fit(DataArray(x, dims, c_fit)).transform(DataArray(xq, dims, c_pred)).values
    assert K.LAUNCHES["rank_map_segments"] > n0
    want = P.PointWiseDownscaler(P.QuantileMapper(detrend=True), device="cpu").fit(
        DataArray(x.astype(np.float64), dims, c_fit)
    ).transform(DataArray(xq.astype(np.float64), dims, c_pred)).values
    d = np.abs(got.astype(np.float64) - want)[~np.isnan(want)]
    assert np.quantile(d, 0.999) <= 2e-3 and d.max() <= 5.0
    # the single-cell API defaults to the card, in float32
    n0 = K.LAUNCHES["batched_interp"]
    qmr = P.QuantileMappingReressor(extrapolate="both").fit(x[:, 1:2], y=x[:, 2])
    assert qmr._X_cdf.vals.dtype == np.float32
    assert np.isfinite(qmr.predict(xq[:, 1:2])).all()
    assert K.LAUNCHES["batched_interp"] >= n0 + 2


# ----------------------------------------------------------------------
# K7, K8 and the GARD family
# ----------------------------------------------------------------------


def _gard_case(rng, C, n, m, f, dup=False, on_train=False):
    """float32 X ~ N(10, 3), y = 0.2 N(10, 3) + 13 (bench.py:1059-1064);
    ``dup`` repeats every training row (exact distance ties), or with
    ``"const"`` makes feature 0 constant and rounds the others to whole
    numbers (every row in a few distance bins: the candidate list
    overflows); ``on_train`` puts every query on a training point (zero
    distances)."""
    X = rng.normal(10, 3, (C, n, f)).astype(np.float32)
    if dup == "const":
        X[..., 0] = 10.0
        X[..., 1:] = np.round(X[..., 1:])
    elif dup:
        X[:, n // 2 : 2 * (n // 2)] = X[:, : n // 2]
    y = (0.2 * rng.normal(10, 3, (C, n)) + 13).astype(np.float32)
    Xq = rng.normal(10, 3, (C, m, f)).astype(np.float32)
    if on_train:
        Xq = X[:, rng.integers(0, n, m)].copy()
    return X, y, Xq


# (C, n, m, f, k, dup, on_train): duplicated rows, queries on training
# points, n not a multiple of 32, k = 1, k = n, f = 1 and 6, training
# records too long to stage in shared memory (read from global memory; the
# second also past 16-bit counts); then a constant feature (one distance a
# query at f = 1, a few bins at f = 3: the candidate list overflows), f = 6
# and f = 5 with k = 4,096 at the shared-memory edge (the cell staged beside
# one warp), m = 67 (not a multiple of the block's warps)
_GARD_SHAPES = [
    (3, 70, 23, 2, 20, False, False),
    (2, 97, 41, 1, 1, True, True),
    (2, 64, 33, 6, 64, True, False),
    (2, 200, 37, 3, 200, False, True),
    (4, 1001, 65, 2, 200, True, True),
    (2, 3650, 9, 5, 4096 - 500, False, False),
    (2, 60_000, 5, 2, 300, True, True),
    (3, 500, 37, 1, 100, "const", False),
    (2, 3000, 21, 3, 200, "const", True),
    (2, 7570, 9, 6, 4096, False, False),
    (2, 8832, 7, 5, 4096, True, False),
    (1, 3650, 67, 2, 200, False, False),
    (2, 70_000, 6, 3, 500, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("C,n,m,f,k,dup,on_train", _GARD_SHAPES)
@pytest.mark.parametrize("thresh", [None, 15.0])
def test_pure_analog_kernel_vs_plain(cuda_device, rng, C, n, m, f, k, dup, on_train, thresh):
    """K7 on the card against its plain version: the exceedance probability
    (a count over k) and the best / sample analog (the raw y of one member)
    bitwise; mean, weighted mean and std within float32 reduction error
    (rtol 1e-5: sums of k terms in another order)."""
    from skdownscale_tpu_torch.kernels import knn as KN

    X, y, Xq = (torch.from_numpy(a).to(cuda_device) for a in _gard_case(rng, C, n, m, f, dup, on_train))
    rand = torch.from_numpy(rng.integers(0, k, (C, m)).astype(np.int32)).to(cuda_device)
    for kind in KN.KINDS:
        kk = 1 if kind == "best_analog" else k
        n0 = KN.LAUNCHES["pure_analog_stats"]
        got = KN.pure_analog_stats(X, y, Xq, rand, k=kk, kind=kind, thresh=thresh)
        torch.cuda.synchronize()
        assert KN.LAUNCHES["pure_analog_stats"] == n0 + 1
        want = KN.pure_analog_stats_plain(X, y, Xq, rand, k=kk, kind=kind, thresh=thresh)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        assert np.array_equal(got[..., 1].view(np.int32), want[..., 1].view(np.int32)), kind
        if kind in ("best_analog", "sample_analogs"):
            assert np.array_equal(got[..., 0].view(np.int32), want[..., 0].view(np.int32)), kind
        npt.assert_array_equal(np.isnan(got), np.isnan(want))
        npt.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=kind)


@pytest.mark.cuda
@pytest.mark.parametrize("C,n,m,f,k,dup,on_train", [s for s in _GARD_SHAPES if s[3] <= 5])
@pytest.mark.parametrize("thresh", [None, 15.0])
def test_analog_regression_kernel_vs_plain(cuda_device, rng, C, n, m, f, k, dup, on_train, thresh):
    """K8 on the card against its plain version: the count row bitwise, the
    other sums within float32 reduction error (atol 1e-3 on sums of up to
    4,096 centred terms of |x| < 20), the Newton probability within 5e-4
    (the JAX package's kernel-vs-gather tolerance)."""
    from skdownscale_tpu_torch.kernels import knn as KN

    X, y, Xq = (torch.from_numpy(a).to(cuda_device) for a in _gard_case(rng, C, n, m, f, dup, on_train))
    n0 = KN.LAUNCHES["analog_regression_stats"]
    stats, prob, mu, ybar = KN.analog_regression_stats(X, y, Xq, k=k, thresh=thresh)
    torch.cuda.synchronize()
    assert KN.LAUNCHES["analog_regression_stats"] == n0 + 1
    ws, wp, wmu, wybar = KN.analog_regression_stats_plain(X, y, Xq, k=k, thresh=thresh)
    assert stats.shape == (C, m, KN.n_stat_rows(f)) and prob.shape == (C, m)
    assert torch.equal(mu, wmu) and torch.equal(ybar, wybar)
    assert torch.equal(stats[..., 0], ws[..., 0])
    npt.assert_allclose(stats.cpu().numpy(), ws.cpu().numpy(), rtol=1e-5, atol=1e-3)
    npt.assert_allclose(prob.cpu().numpy(), wp.cpu().numpy(), rtol=0, atol=5e-4)


@pytest.mark.cuda
def test_knn_launch_geometry_stages_what_fits(cuda_device):
    """Config 4's cell and the cells at the shared-memory edge (one warp's
    counters and k = 4,096 members beside the staged rows fill the 232,448
    bytes a block may take) are staged, one row more or a 60,000-row cell is
    not; every shape gets at least one block an SM."""
    from skdownscale_tpu_torch.kernels import knn as KN

    for kernel, (C, n, m, f, k), staged in [
        ("pure_analog_stats", (2048, 3650, 365, 2, 200), 1),
        ("analog_regression_stats", (2048, 3650, 365, 2, 200), 1),
        ("pure_analog_stats", (2, 7570, 9, 6, 4096), 1),
        ("pure_analog_stats", (2, 7571, 9, 6, 4096), 0),
        ("analog_regression_stats", (2, 8832, 7, 5, 4096), 1),
        ("analog_regression_stats", (2, 8833, 7, 5, 4096), 0),
        ("pure_analog_stats", (2, 60_000, 5, 2, 300), 0),
    ]:
        g = KN.launch_geometry(kernel, C, n, m, f, k)
        assert g["staged"] == staged, (kernel, n, g)
        assert g["blocks_per_sm"] >= 1 and 1 <= g["warps"] <= min(m, 16)
        assert g["resident_warps"] == g["warps"] * g["blocks_per_sm"]


@pytest.mark.cuda
def test_knn_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    from skdownscale_tpu_torch.kernels import knn as KN

    X = torch.zeros((2, 50, 2), device=cuda_device)
    y = torch.zeros((2, 50), device=cuda_device)
    r = torch.zeros((2, 10), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):  # float64
        KN.pure_analog_stats(X.double(), y.double(), X[:, :10].double(), r, k=5, kind="mean_analogs")
    with pytest.raises(ValueError):  # seven features
        KN.pure_analog_stats(torch.zeros((2, 50, 7), device=cuda_device), y,
                             torch.zeros((2, 10, 7), device=cuda_device), r, k=5, kind="mean_analogs")
    with pytest.raises(ValueError):  # six features for K8
        KN.analog_regression_stats(torch.zeros((2, 50, 6), device=cuda_device), y,
                                   torch.zeros((2, 10, 6), device=cuda_device), k=5)
    with pytest.raises(ValueError):  # k above n
        KN.analog_regression_stats(X, y, X[:, :10].contiguous(), k=51)
    with pytest.raises(ValueError):  # not contiguous
        KN.pure_analog_stats(X, y, X[:, ::5], r, k=5, kind="mean_analogs")
    with pytest.raises(TypeError):  # int64 ranks
        KN.pure_analog_stats(X, y, X[:, :10].contiguous(), r.long(), k=5, kind="sample_analogs")


def _gard_grid(rng, C, T_fit=730, T_pred=365, f=2):
    """A (time, cell) grid of f variables as a Dataset, with three NaN cells."""
    from skdownscale_tpu_torch.xlite import Dataset

    idx = pd.date_range("1990-01-01", periods=T_fit, freq="D")
    idx_p = pd.date_range("2000-01-01", periods=T_pred, freq="D")
    dims = ("time", "cell")
    c_fit, c_pred = {"time": idx, "cell": np.arange(C)}, {"time": idx_p, "cell": np.arange(C)}

    def ds(T, coords):
        v = {f"v{j}": rng.normal(10, 3, (T, C)).astype(np.float32) for j in range(f)}
        for a in v.values():
            a[:, [0, 5, 17]] = np.nan
        return v, coords

    fit, pred = ds(T_fit, c_fit), ds(T_pred, c_pred)
    y = (0.2 * rng.normal(10, 3, (T_fit, C)) + 13).astype(np.float32)
    y[:, [0, 5, 17]] = np.nan

    def make(dtype):
        X = Dataset({k: DataArray(a.astype(dtype), dims, fit[1]) for k, a in fit[0].items()})
        Xq = Dataset({k: DataArray(a.astype(dtype), dims, pred[1]) for k, a in pred[0].items()})
        return X, DataArray(y.astype(dtype), dims, c_fit), Xq

    return make


@pytest.mark.cuda
@pytest.mark.parametrize(
    "model,kernel",
    [
        (lambda: P.PureAnalog(n_analogs=50, kind="mean_analogs", thresh=15.0), "pure_analog_stats"),
        (lambda: P.PureAnalog(n_analogs=50, kind="sample_analogs", random_state=3), "pure_analog_stats"),
        (lambda: P.AnalogRegression(n_analogs=50, thresh=15.0), "analog_regression_stats"),
        (lambda: P.PureRegression(thresh=15.0), None),
    ],
)
def test_gard_grid_on_cuda_launches_the_kernels_not_the_plain_versions(cuda_device, rng, monkeypatch, model, kernel):
    """The grid route on CUDA float32 launches K7 / K8 (the plain versions
    are made to raise), keeps NaN cells NaN and agrees with the port's CPU
    float64 path: exceedance probabilities and sampled analogs exactly
    where the same analogs are selected, so at most 1% of values may move
    by a near-tie swap at the k-th boundary (Δy/k, 1/k, or a flip of pred
    to 0 under the threshold); the bulk (99th percentile) within 1e-3."""
    from skdownscale_tpu_torch.kernels import knn as KN

    make = _gard_grid(rng, 96)
    X, Y, Xq = make(np.float32)
    for name in ("pure_analog_stats_plain", "analog_regression_stats_plain"):
        monkeypatch.setattr(KN, name, lambda *a, **k: (_ for _ in ()).throw(AssertionError("plain version on CUDA")))
    n0 = KN.LAUNCHES[kernel] if kernel else 0
    got = P.PointWiseDownscaler(model(), device=cuda_device).fit(X, Y).predict(Xq)
    if kernel:
        assert KN.LAUNCHES[kernel] == n0 + 1
    monkeypatch.undo()
    X64, Y64, Xq64 = make(np.float64)
    want = P.PointWiseDownscaler(model(), device="cpu").fit(X64, Y64).predict(Xq64)
    assert got.dims == want.dims == ("time", "variable", "cell")
    assert list(got.coords["variable"]) == ["pred", "exceedance_prob", "prediction_error"]
    g, w = got.values.astype(np.float64), want.values
    assert np.isnan(g[..., [0, 5, 17]]).all()
    both = ~np.isnan(g) & ~np.isnan(w)
    assert np.mean(np.isnan(g) != np.isnan(w)) <= 1e-2
    d = np.abs(g - w)[both]
    assert np.quantile(d, 0.99) <= 1e-3 and np.mean(d > 1e-3) <= 1e-2


@pytest.mark.cuda
def test_gard_single_cell_runs_on_the_card(cuda_device, rng):
    from skdownscale_tpu_torch.kernels import knn as KN

    X = rng.normal(10, 3, (400, 2))
    y = 0.2 * rng.normal(10, 3, 400) + 13
    n0 = dict(KN.LAUNCHES)
    pa = P.PureAnalog(n_analogs=30, kind="weight_analogs", thresh=15.0).fit(X, y)
    ar = P.AnalogRegression(n_analogs=30, thresh=15.0).fit(X, y)
    for est in (pa, ar, P.PureRegression(thresh=15.0).fit(X, y)):
        out = est.predict(X[:50])
        assert out.shape == (50, 3) and out.dtype == np.float32
    assert KN.LAUNCHES["pure_analog_stats"] == n0.get("pure_analog_stats", 0) + 1
    assert KN.LAUNCHES["analog_regression_stats"] == n0.get("analog_regression_stats", 0) + 1


# ----------------------------------------------------------------------
# K9 and MBCn
# ----------------------------------------------------------------------


def _k9_rows(rng, B, L):
    """Adversarial float32 rows plus the NaN whose key is INT32_MAX (bits
    0x7fffffff), which ties with the TPU kernel's pad key (ROADMAP F8)."""
    x = _adversarial(rng, B, L)
    u = x.view(np.uint32).reshape(-1)
    u[rng.integers(0, u.size, max(1, u.size // 300))] = 0x7FFFFFFF
    return x


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,L",
    [(4096, 1), (4096, 7), (2048, 620), (512, 3650), (32, 8192),
     # a warp a row (L <= 1,024, four rows a block) and a block a row around
     # the edge between them, with row counts that leave a block part full
     (6144, 304), (3001, 620), (64, 1024), (64, 1025), (8, 33), (7, 8191)],
)
def test_k9_forms_bitwise_vs_plain(cuda_device, rng, B, L):
    from skdownscale_tpu_torch.kernels import sort_rows as S

    x = torch.from_numpy(_k9_rows(rng, B, L)).to(cuda_device)
    v = torch.from_numpy(rng.normal(0, 1, (B, L)).astype(np.float32)).to(cuda_device)
    n0 = dict(S.LAUNCHES)
    s1 = S.sort_rows(x)
    s2, p2 = S.sort_rows_with_positions(x)
    u = S.unsort_rows(v, p2)
    back = S.unsort_rows(s2, p2)
    torch.cuda.synchronize()
    assert S.LAUNCHES["sort_rows"] == n0.get("sort_rows", 0) + 1
    assert S.LAUNCHES["sort_rows_with_positions"] == n0.get("sort_rows_with_positions", 0) + 1
    assert S.LAUNCHES["unsort_rows"] == n0.get("unsort_rows", 0) + 2
    w2, wp2 = S.sort_rows_with_positions_plain(x)
    assert torch.equal(s1.view(torch.int32), S.sort_rows_plain(x).view(torch.int32))
    assert torch.equal(s2.view(torch.int32), w2.view(torch.int32))
    assert p2.dtype == torch.int32 and torch.equal(p2, wp2)
    assert torch.equal(u.view(torch.int32), S.unsort_rows_plain(v, p2).view(torch.int32))
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))


@pytest.mark.cuda
def test_k9_above_its_limit_takes_the_plain_route(cuda_device, rng):
    """Rows of K9_MAX_LEN + 1: the wrappers raise, and the callers' shape
    route (MBCn's reorder, the BCSD group sort) takes the plain version and
    launches nothing."""
    from skdownscale_tpu_torch.kernels import sort_rows as S
    from skdownscale_tpu_torch.models import mbc as PM
    from skdownscale_tpu_torch.models.grouped import _sort_within_groups
    from skdownscale_tpu_torch.utils.timeindex import PaddedGroups

    L = S.K9_MAX_LEN + 1
    x = torch.from_numpy(rng.normal(0, 1, (6, L)).astype(np.float32)).to(cuda_device)
    t = torch.from_numpy(rng.normal(0, 1, (6, L)).astype(np.float32)).to(cuda_device)
    for call in (lambda: S.sort_rows(x), lambda: S.sort_rows_with_positions(x)):
        with pytest.raises(ValueError):
            call()
    n0 = dict(S.LAUNCHES)
    out = PM.rank_reorder(x, t)
    groups = PaddedGroups.from_labels(np.zeros(L, np.int64), np.arange(1))
    srt = _sort_within_groups(x, groups)
    torch.cuda.synchronize()
    assert dict(S.LAUNCHES) == n0
    assert torch.equal(srt.view(torch.int32), S.sort_rows_plain(x).view(torch.int32))
    assert torch.equal(torch.sort(out, dim=1).values, torch.sort(x, dim=1).values)


@pytest.mark.cuda
def test_k9_wrappers_raise_on_what_the_kernel_does_not_take(cuda_device):
    from skdownscale_tpu_torch.kernels import sort_rows as S

    x = torch.zeros((4, 50), device=cuda_device)
    pos = torch.zeros((4, 50), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        S.sort_rows(x.double())
    with pytest.raises(ValueError):  # not contiguous
        S.sort_rows_with_positions(torch.zeros((4, 100), device=cuda_device)[:, ::2])
    with pytest.raises(TypeError):  # int64 positions
        S.unsort_rows(x, pos.long())
    with pytest.raises(ValueError):  # positions on another device
        S.unsort_rows(x, pos.cpu())


def _mbcn_cells(rng, C, T, d=3):
    corr = 0.6 * np.ones((d, d)) + 0.4 * np.eye(d)
    y = rng.standard_normal((C, T, d)) @ np.linalg.cholesky(corr).T
    xh = rng.standard_normal((C, T, d)) * 1.4 + 1.0
    xf = rng.standard_normal((C, T, d)) * 1.4 + 1.3
    return [a.astype(np.float32) for a in (y, xh, xf)]


@pytest.mark.cuda
def test_mbcn_on_cuda_launches_k9_and_k6_not_the_plain_versions(cuda_device, rng, monkeypatch):
    """MBCn on the card launches K9 (22 of each form at 20 rotations) and K6
    (one a rotation) with the plain versions made to raise; each output row
    is a permutation of the card's QDM margin row, bitwise; after 3
    rotations at most 1% of time steps take another rank than on the CPU
    in float64, p99.9 |diff| <= 0.004 (chip_smoke.py's limits)."""
    from skdownscale_tpu_torch.kernels import interp as I
    from skdownscale_tpu_torch.kernels import sort_rows as S
    from skdownscale_tpu_torch.models import mbc as PM

    y, xh, xf = _mbcn_cells(rng, 64, 3650)
    kinds = ("difference",) * 3
    rots = PM.mbcn_rotations(3, 20, 0)
    dev = [torch.from_numpy(a).to(cuda_device) for a in (y, xh, xf)]
    def raiser(*a, **k):
        raise AssertionError("a plain version ran on CUDA")

    # the wrappers' fallback and on_rows' long-row route
    for name in ("sort_rows_plain", "sort_rows_with_positions_plain", "unsort_rows_plain"):
        monkeypatch.setattr(S, name, raiser)
    monkeypatch.setattr(I, "batched_interp_plain", raiser)
    n0 = dict(S.LAUNCHES)
    oh, of = PM.mbcn_correct(*dev, rots, kinds=kinds)
    torch.cuda.synchronize()
    for form in ("sort_rows", "sort_rows_with_positions", "unsort_rows"):
        assert S.LAUNCHES[form] == n0.get(form, 0) + 22, form
    assert S.LAUNCHES["batched_interp"] >= n0.get("batched_interp", 0) + 20
    mh, mf = PM.mbcn_margins(*dev, kinds=kinds)
    for out, marg in ((oh, mh), (of, mf)):
        got = torch.sort(out.transpose(1, 2).contiguous(), dim=-1).values
        assert torch.equal(got.view(torch.int32), torch.sort(marg, dim=-1).values.view(torch.int32))
    monkeypatch.undo()
    got = PM.mbcn_correct(*dev, rots[:3], kinds=kinds)
    want = PM.mbcn_correct(*(torch.from_numpy(a.astype(np.float64)) for a in (y, xh, xf)), rots[:3], kinds=kinds)
    for g, w in zip(got, want):
        g, w = g.double().cpu().numpy(), w.numpy()
        rg = np.argsort(np.argsort(g, axis=1, kind="stable"), axis=1, kind="stable")
        rw = np.argsort(np.argsort(w, axis=1, kind="stable"), axis=1, kind="stable")
        assert np.mean(rg != rw) <= 0.01
        assert np.quantile(np.abs(g - w), 0.999) <= 0.004


@pytest.mark.cuda
def test_mbcn_grid_and_single_cell_on_the_card(cuda_device, rng):
    """``mbcn_grid`` defaults to the card: float32 out, NaN cells NaN; the
    single-cell ``MBCn`` runs there too."""
    from skdownscale_tpu_torch.kernels import sort_rows as S
    from skdownscale_tpu_torch.models import mbc as PM
    from skdownscale_tpu_torch.xlite import Dataset

    T, ny, nx = 400, 4, 5
    idx = pd.date_range("1990-01-01", periods=T, freq="D")
    coords = {"time": idx, "y": np.arange(ny), "x": np.arange(nx)}

    def ds(loc):
        out = {}
        for j in range(2):
            a = rng.normal(loc + j, 1.5, (T, ny, nx)).astype(np.float32)
            a[:, 0, 0] = np.nan
            out[f"v{j}"] = DataArray(a, ("time", "y", "x"), coords)
        return Dataset(out)

    n0 = S.LAUNCHES["sort_rows"]
    oh, of = PM.mbcn_grid(ds(0.0), ds(1.0), ds(1.3), n_iterations=4, group="month")
    assert S.LAUNCHES["sort_rows"] == n0 + 6 * 12
    for out in (oh, of):
        a = out["v0"].values
        assert a.dtype == np.float32 and np.isnan(a[:, 0, 0]).all() and np.isfinite(a[:, 1:]).all()
    y, xh, xf = (a[0] for a in _mbcn_cells(rng, 1, 500))
    m = P.MBCn(n_iterations=5).fit(xh, y)
    out = m.predict(xf)
    assert out.dtype == np.float32 and out.shape == xf.shape and np.isfinite(out).all()


@pytest.mark.cuda
def test_k6_at_the_pooled_models_shapes_bitwise_vs_plain(cuda_device, rng):
    """K6 at config G's two shapes at a tenth of their size: one row of
    sorted knots with a +inf-padded tail and the 2,048 plotting positions
    as queries (the ladder), and every cell row against one shared 2,048-knot
    table (the map)."""
    from skdownscale_tpu_torch.global_models.quantile import ladder_positions
    from skdownscale_tpu_torch.kernels import interp as I

    N = 24_000_000
    vals = torch.sort(torch.randn(N, device=cuda_device) * 3 + 283).values
    sp = ((torch.arange(N, dtype=torch.float64, device=cuda_device) + 0.6) / (N - 1000 + 0.2)).float()
    sp[-1000:] = float("inf")
    vals[-1000:] = vals[-1001]
    pp = ladder_positions(2048, torch.float32, cuda_device)
    table = torch.sort(torch.randn(2048, device=cuda_device) * 2 + 282).values
    q = torch.from_numpy(rng.normal(284, 3, (6554, 3650)).astype(np.float32)).to(cuda_device)
    q[:5] = float("nan")
    q[7, :100] = table[:100]  # knot hits
    for args in ((sp[None], vals[None], pp[None]), (table[None], table[None] * 0.9 + 25, q)):
        n0 = I.LAUNCHES["batched_interp"]
        got = I.batched_interp(*args)
        torch.cuda.synchronize()
        assert I.LAUNCHES["batched_interp"] == n0 + 1
        assert torch.equal(got.view(torch.int32), I.batched_interp_plain(*args).view(torch.int32))


@pytest.mark.cuda
def test_pooled_models_on_the_card_match_the_cpu(cuda_device, rng):
    """``GlobalDownscaler`` defaults to the card: the mapper's fit launches
    K6 twice (two ladders) and its transform once; ladders, coefficients
    and outputs agree with the CPU float64 path."""
    from skdownscale_tpu_torch.kernels import LAUNCHES

    T, ny, nx = 900, 8, 10
    data = rng.normal(283, 3, (T, ny, nx)).astype(np.float32)
    data[:, 0, 0] = np.nan
    obs = (data * 0.9 + 25 + rng.normal(0, 0.5, (T, ny, nx))).astype(np.float32)
    dims, coords = ("time", "y", "x"), {"time": np.arange(T), "y": np.arange(ny), "x": np.arange(nx)}
    X, Y = DataArray(data, dims, coords), DataArray(obs, dims, coords)
    n0 = LAUNCHES["batched_interp"]
    gd = P.GlobalDownscaler(P.GlobalQuantileMapper(n_quantiles=512)).fit(X, Y)
    assert LAUNCHES["batched_interp"] == n0 + 2
    out = gd.transform(X).values
    assert LAUNCHES["batched_interp"] == n0 + 3 and out.dtype == np.float32
    ref = P.GlobalDownscaler(P.GlobalQuantileMapper(n_quantiles=512), device="cpu")
    X64, Y64 = (DataArray(a.values.astype(np.float64), dims, coords) for a in (X, Y))
    want = ref.fit(X64, Y64).transform(X64).values
    npt.assert_array_equal(np.isnan(out), np.isnan(want))
    npt.assert_allclose(out, want, atol=2e-3, equal_nan=True)
    for cell_intercepts in (False, True):
        pred = P.GlobalDownscaler(P.GlobalLinearRegressor(cell_intercepts=cell_intercepts)).fit(X, Y).predict(X)
        want = P.GlobalDownscaler(P.GlobalLinearRegressor(cell_intercepts=cell_intercepts),
                                  device="cpu").fit(X64, Y64).predict(X64)
        npt.assert_allclose(pred.values, want.values, atol=2e-3, equal_nan=True)


@pytest.mark.cuda
def test_exact_ladder_raises_past_k6_and_past_free_memory(cuda_device, monkeypatch):
    """A ladder row longer than K6 takes, or a sort that does not fit the
    card, raises with its size; nothing falls back."""
    from skdownscale_tpu_torch.global_models import quantile as GQ

    x = torch.randn(40, 50, device=cuda_device)
    monkeypatch.setattr(GQ, "_K6_MAX_KNOTS", 1000)
    with pytest.raises(ValueError, match="2000 samples"):
        P.GlobalQuantileMapper().fit(x, x)
    monkeypatch.setattr(GQ, "_K6_MAX_KNOTS", 2**31 - 1)
    monkeypatch.setattr(GQ, "_LADDER_BYTES_PER_SAMPLE", 2**40)
    with pytest.raises(MemoryError, match="2000 samples"):
        P.GlobalQuantileMapper().fit(x, x)


@pytest.mark.cuda
def test_zscore_and_arrm_grids_and_single_cells_on_the_card(cuda_device, rng, monkeypatch):
    """``ZScoreRegressor`` takes the banded rolling form on the card and
    matches the CPU float64 path, in one pass and in several; ARRM fits in
    float64 on the card, so its 'arrm' breaks equal the CPU's; both
    single-cell APIs run on the card."""
    from skdownscale_tpu_torch.models import batched as PB
    from skdownscale_tpu_torch.ops import rolling as R

    T, C = 1500, 40
    idx = pd.date_range("1990-01-01", periods=T, freq="D")
    seas = 10 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25)
    x = (284.5 + seas[:, None] + rng.normal(0, 2, (T, C))).astype(np.float32)
    y = (282 + seas[:, None] + rng.normal(0, 1.8, (T, C))).astype(np.float32)
    x[:, 0] = y[:, 0] = np.nan
    assert R.use_stats_matmul(torch.from_numpy(x.T.copy()).to(cuda_device), 31)
    dims, c = ("time", "cell"), {"time": idx, "cell": np.arange(C)}
    X, Y = DataArray(x, dims, c), DataArray(y, dims, c)
    X64, Y64 = (DataArray(a.values.astype(np.float64), dims, c) for a in (X, Y))
    got = P.PointWiseDownscaler(P.ZScoreRegressor()).fit(X, Y).predict(X).values
    want = P.PointWiseDownscaler(P.ZScoreRegressor(), device="cpu").fit(X64, Y64).predict(X64).values
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_allclose(got, want, atol=5e-3, equal_nan=True)
    monkeypatch.setattr(PB, "ZSCORE_PASS_ELEMENTS", 15 * T)  # passes of 15 cells
    passes = P.PointWiseDownscaler(P.ZScoreRegressor()).fit(X, Y).predict(X).values
    npt.assert_allclose(passes, got, atol=1e-4, equal_nan=True)
    xa = rng.uniform(-10, 15, (T, C)).astype(np.float32)
    ya = (np.abs(xa) + rng.normal(0, 0.3, (T, C))).astype(np.float32)
    A, B = DataArray(xa, dims, c), DataArray(ya, dims, c)
    A64, B64 = (DataArray(a.values.astype(np.float64), dims, c) for a in (A, B))
    card = P.PointWiseDownscaler(P.PiecewiseLinearRegression(n_segments=6, fit_option="arrm")).fit(A, B)
    cpu = P.PointWiseDownscaler(P.PiecewiseLinearRegression(n_segments=6, fit_option="arrm"),
                                device="cpu").fit(A64, B64)
    npt.assert_array_equal(card.get_attr("fit_breaks_").values, cpu.get_attr("fit_breaks_").values)
    npt.assert_allclose(card.predict(A).values, cpu.predict(A64).values, atol=1e-4)
    frame = pd.DataFrame({"t": x[:, 1]}, index=idx)
    z = P.ZScoreRegressor().fit(frame, pd.DataFrame({"t": y[:, 1]}, index=idx))
    assert np.isfinite(z.shift_).all() and z.predict(frame).shape == (T, 1)
    pw = P.PiecewiseLinearRegression(fit_option="fast").fit(xa[:, :1], ya[:, 0])
    assert np.isfinite(pw.predict(xa[:, :1])).all()


@pytest.mark.cuda
def test_pipeline_on_the_card_stages_pinned_and_matches_the_runner(cuda_device, rng):
    """``run_pointwise_pipeline`` on the card: pinned staging, K1 and K2
    once per band, the output against ``PointWiseDownscaler`` on the card
    and the CPU float64 path within the BCSD limits; a checkpoint of the
    card's runner loads back on the card and predicts the same bits."""
    import tempfile

    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.parallel.pipeline import run_pointwise_pipeline
    from skdownscale_tpu_torch.parallel.zarr_io import ZarrGridSource
    from skdownscale_tpu_torch.utils import checkpoint, zarrlite

    T, ny, nx = 240, 12, 16
    idx = pd.date_range("1980-01-01", periods=T, freq="MS")
    seas = 8 * np.sin(2 * np.pi * (idx.month.to_numpy() - 1) / 12)[:, None, None]
    g = (284.5 + seas + rng.normal(0, 2, (T, ny, nx))).astype(np.float32)
    o = (282.0 + seas + rng.normal(0, 1.8, (T, ny, nx))).astype(np.float32)
    g[:, 3, 4] = o[:, 3, 4] = np.nan
    store, out = {}, {}
    zarrlite.save_group(store, {"gcm": g, "obs": o}, chunks=(T, 4, nx), compressor="zlib", zarr_format=3)
    zarrlite.save_array(store, np.asarray(idx, dtype="datetime64[ns]").view(np.int64), prefix="time",
                        zarr_format=3, attrs={"kind": "datetime64[ns]"})
    LAUNCHES.clear()
    rep = run_pointwise_pipeline(store, out, cell_chunk=64, device=cuda_device)
    assert rep.n_chunks == 3 and rep.stages["pinned"] and rep.device_s > 0
    assert LAUNCHES["count_sort_segments"] == LAUNCHES["rank_map_segments"] == 3
    got = ZarrGridSource(out, "corrected").read_cells(0, ny * nx, dtype=np.float32)
    dims, c = ("time", "y", "x"), {"time": idx, "y": np.arange(ny), "x": np.arange(nx)}
    runner = P.PointWiseDownscaler(P.BcsdTemperature(return_anoms=False)).fit(
        DataArray(g, dims, c), DataArray(o, dims, c))
    card = runner.predict(DataArray(g, dims, c)).values.reshape(T, -1).T
    g64, o64 = DataArray(g.astype(np.float64), dims, c), DataArray(o.astype(np.float64), dims, c)
    cpu = P.PointWiseDownscaler(P.BcsdTemperature(return_anoms=False), device="cpu").fit(g64, o64)
    for want in (card, cpu.predict(g64).values.reshape(T, -1).T):  # the BCSD limits
        npt.assert_array_equal(np.isnan(got), np.isnan(want))
        d = np.abs(got - want)[np.isfinite(want)]
        assert np.quantile(d, 0.999) <= 1e-3 and np.mean(d > 1e-3) <= 1e-3 and d.max() <= 5.0
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save(f"{tmp}/m.ckpt", runner)
        back = checkpoint.load(f"{tmp}/m.ckpt")
    assert back._state[0].vals.is_cuda
    npt.assert_array_equal(back.predict(DataArray(g, dims, c)).values, runner.predict(DataArray(g, dims, c)).values)


@pytest.mark.cuda
def test_disaggregation_and_metrics_on_the_card_match_the_cpu(cuda_device, rng):
    from skdownscale_tpu_torch.utils import disagg, metrics

    anoms = rng.normal(0, 1.5, (24, 16, 16)).astype(np.float32)
    anoms[:, 2, 3] = np.nan
    climo = (283 + rng.normal(0, 3, (12, 64, 64))).astype(np.float32)
    labels = np.arange(24) % 12
    for method in ("bilinear", "cubic", "nearest", "lanczos3"):
        got = disagg.spatial_disaggregate(anoms, climo, labels, method=method, nan_aware=True)
        assert got.is_cuda and got.dtype == torch.float32
        want = disagg.spatial_disaggregate(anoms.astype(np.float64), climo.astype(np.float64), labels,
                                           method=method, nan_aware=True, device="cpu")
        npt.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, equal_nan=True)
    mi = pd.date_range("2000-01-01", periods=24, freq="MS")
    oi = pd.date_range("2000-01-01", "2001-12-31", freq="D")
    monthly = (283 + rng.normal(0, 2, (24, 40))).astype(np.float32)
    obs = (283 + rng.normal(0, 2, (len(oi), 40))).astype(np.float32)
    got = disagg.temporal_disaggregate(monthly, mi, obs, oi)
    want = disagg.temporal_disaggregate(monthly.astype(np.float64), mi, obs.astype(np.float64), oi,
                                        device="cpu")
    npt.assert_allclose(got.cpu().numpy(), want.numpy(), atol=5e-4)
    t, p = (torch.from_numpy(obs.T.copy()).to(cuda_device), torch.from_numpy(obs.T[::-1].copy()).to(cuda_device))
    for k, v in metrics.score_all(t, p).items():
        ref = metrics.score_all(t.double().cpu(), p.double().cpu())[k]
        npt.assert_allclose(v.double().cpu().numpy(), ref.numpy(), atol=1e-4)
    rep = metrics.validation_report(t, {"rev": p})
    ref = metrics.validation_report(t.double().cpu(), {"rev": p.double().cpu()})
    npt.assert_allclose(rep.to_numpy(), ref.to_numpy(), atol=1e-4)
    arrays = metrics.validation_report(obs.T, {"rev": obs.T[::-1]})  # arrays go to the card
    npt.assert_allclose(arrays.to_numpy(), rep.to_numpy(), atol=1e-4)


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["arrm", "zscore"])
def test_checkpoint_of_a_card_grid_loads_back_on_the_card_bitwise(cuda_device, rng, tmp_path, kind):
    """A grid fitted on the card loads back on the card in the dtypes it
    was saved in (ARRM's float64, ZScore's float32) and predicts the same
    bits; a CPU float64 save loads on the card in float32, except ARRM's
    state, which is float64 on every device."""
    from skdownscale_tpu_torch.utils import checkpoint

    freq, T = ("MS", 240) if kind == "arrm" else ("D", 1095)
    idx = pd.date_range("1980-01-01", periods=T, freq=freq)
    x = (284.5 + rng.normal(0, 2, (T, 3, 5))).astype(np.float32)
    y = (282.0 + 0.9 * (x - 284.5) + rng.normal(0, 1, (T, 3, 5))).astype(np.float32)
    x[:, 1, 2] = y[:, 1, 2] = np.nan
    dims, c = ("time", "lat", "lon"), {"time": idx, "lat": np.arange(3.0), "lon": np.arange(5.0)}

    def model():
        return (P.PiecewiseLinearRegression(n_segments=3, fit_option="fast") if kind == "arrm"
                else P.ZScoreRegressor())

    card = P.PointWiseDownscaler(model(), device=cuda_device).fit(DataArray(x, dims, c), DataArray(y, dims, c))
    checkpoint.save(str(tmp_path / "card.ckpt"), card)
    back = checkpoint.load(str(tmp_path / "card.ckpt"), device=cuda_device)
    for a, b in zip(_tensors(back._state), _tensors(card._state)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
    X = DataArray(x, dims, c)
    npt.assert_array_equal(back.predict(X).values, card.predict(X).values)

    x64, y64 = DataArray(x.astype(np.float64), dims, c), DataArray(y.astype(np.float64), dims, c)
    cpu = P.PointWiseDownscaler(model(), device="cpu").fit(x64, y64)
    checkpoint.save(str(tmp_path / "cpu.ckpt"), cpu)
    moved = checkpoint.load(str(tmp_path / "cpu.ckpt"), device=cuda_device)
    want = torch.float64 if kind == "arrm" else torch.float32
    assert all(t.dtype == want for t in _tensors(moved._state) if t.is_floating_point())
    npt.assert_allclose(moved.predict(X).values, cpu.predict(x64).values, atol=1e-3, equal_nan=True)


@pytest.mark.cuda
def test_meshes_of_one_card_match_the_unsharded_runs(cuda_device, rng, monkeypatch, tmp_path):
    """A mesh of repeated card devices: the sharded runner (dense BCSD, K1
    and K2 once a shard) against the unsharded one, a grid whose exact
    ladder is above K6's row limit fit by the sketch, and a zarr store fed
    as float32 shards.

    Shards of 13 cells are not bitwise equal to one pass of 39 here:
    PyTorch's CUDA reductions and cuBLAS choose their kernels, and so their
    order of addition, by the row count, which moves values by rounding
    (and a near-tied rank by a step of its CDF).  They are held to the
    BCSD limits of ``chip_smoke.py`` (p99.9 of |diff| <= 1e-3 K, at most
    0.1% of values above 1e-3 K, none above 5 K); at config 2's shard
    sizes ``chip_smoke.py`` holds the sharded run bitwise."""
    from skdownscale_tpu_torch.global_models import quantile as GQ
    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.parallel import cell_mesh, feed_zarr_cells
    from skdownscale_tpu_torch.utils import zarrlite

    mesh = cell_mesh([cuda_device] * 3)
    idx = pd.date_range("1980-01-01", periods=120, freq="MS")
    x = (284 + rng.normal(0, 2, (120, 40))).astype(np.float32)
    y = (283 + rng.normal(0, 1.8, (120, 40))).astype(np.float32)
    x[:, 5] = y[:, 5] = np.nan
    X, Y = (DataArray(a, ("time", "cell"), {"time": idx, "cell": np.arange(40)}) for a in (x, y))
    one = P.PointWiseDownscaler(P.BcsdTemperature(return_anoms=False), device=cuda_device).fit(X, Y).predict(X)
    LAUNCHES.clear()
    three = P.PointWiseDownscaler(P.BcsdTemperature(return_anoms=False), sharding=mesh).fit(X, Y).predict(X)
    assert LAUNCHES["count_sort_segments"] == LAUNCHES["rank_map_segments"] == 3
    a, b = three.values.astype(np.float64), one.values.astype(np.float64)
    npt.assert_array_equal(np.isnan(a), np.isnan(b))
    d = np.abs(a - b)[np.isfinite(b)]
    assert np.quantile(d, 0.999) <= 1e-3 and np.mean(d > 1e-3) <= 1e-3 and d.max() <= 5.0

    g = torch.randn(40, 50, device=cuda_device)
    monkeypatch.setattr(GQ, "_K6_MAX_KNOTS", 1000)
    with pytest.raises(ValueError, match="pass a cell mesh"):
        P.GlobalQuantileMapper().fit(g, g)
    st = P.GlobalQuantileMapper(mesh=cell_mesh([cuda_device] * 2), sample_per_shard=64).fit(g, g).state_
    assert int(st.n_x) == 2000 and bool(torch.isfinite(st.x_ladder).all())

    path = str(tmp_path / "g.zarr")
    zarrlite.save_group(path, {"gcm": x.astype(np.float64)}, chunks=(120, 16))
    sc, n, _ = feed_zarr_cells(path, mesh, var="gcm")
    assert n == 40 and all(s.dtype == torch.float32 and s.is_cuda for s in sc.shards)
    npt.assert_array_equal(sc.gather()[:40], x.T)
