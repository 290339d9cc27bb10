"""The port's MBCn (``models/mbc.py``) against the JAX package's on the CPU,
in float64: the host tables bitwise, the rank map and reorder, the cores
(whole-series and monthly), the grid runner with NaN cells and chunks, the
sklearn wrapper, and fitted state carried across by ``convert.py``.  Every
row sort runs K9's plain versions (``kernels/sort_rows.py``), every
interpolation K6's.

Tolerance: ``atol = 1e-10`` on values of order 1-10: the same float64
arithmetic in another order (the rotation products, the interp closed
form).  The rows are continuous random data, so no near-tie can flip a
rank at that size.
"""

import contextlib

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import skdownscale_tpu.models.mbc as JM
from skdownscale_tpu.xlite import DataArray as JDA
from skdownscale_tpu.xlite import Dataset as JDS

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.models.mbc as PM
from skdownscale_tpu_torch.convert import mbcn_state_from_jax
from skdownscale_tpu_torch.models.base import SingleCellEstimator
from skdownscale_tpu_torch.xlite import DataArray as PDA
from skdownscale_tpu_torch.xlite import Dataset as PDS

ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Every jitted MBCn shape keeps about 170 memory maps of compiled code,
    this module compiles some 55 of them, and one process running the whole
    suite holds every earlier module's programs as well, close to the
    kernel's 65,530-map limit (``vm.max_map_count``), past which the XLA
    compiler crashes.  Drop the compiled programs before and after."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def single_cell_on_cpu(monkeypatch):
    """The single-cell API runs on the card by default; these tests ask for
    the CPU (float64)."""
    monkeypatch.setattr(SingleCellEstimator, "single_cell_device", torch.device("cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_allclose(got, want, rtol=0, atol=atol)


def _blocks(rng, C, m, n, p, d, positive=()):
    """(y_obs, x_hist, x_fut) of shapes (C, m|n|p, d), correlated obs; the
    columns in ``positive`` are gamma-distributed (ratio kind)."""
    corr = 0.6 * np.ones((d, d)) + 0.4 * np.eye(d)
    y = rng.standard_normal((C, m, d)) @ np.linalg.cholesky(corr).T
    xh = rng.standard_normal((C, n, d)) * 1.4 + 1.0
    xf = rng.standard_normal((C, p, d)) * 1.4 + 1.3
    for j in positive:
        y[..., j] = rng.gamma(2.0, 2.0, (C, m)) + 0.1
        xh[..., j] = rng.gamma(2.0, 3.0, (C, n)) + 0.1
        xf[..., j] = rng.gamma(2.0, 3.5, (C, p)) + 0.1
    return y, xh, xf


# ----------------------------------------------------------------------
# host tables, rank map, reorder
# ----------------------------------------------------------------------


def test_rotations_bitwise():
    for d, R, seed in ((2, 5, 0), (3, 20, 0), (4, 7, 3)):
        npt.assert_array_equal(PM.mbcn_rotations(d, R, seed), JM.mbcn_rotations(d, R, seed))


@pytest.mark.parametrize("n,m", [(57, 83), (3650, 3650), (300, 280), (1, 5), (40, 1)])
def test_rank_bracket_bitwise(n, m):
    for got, want in zip(PM._rank_bracket(n, m, 0.4, 0.4), JM._rank_bracket(n, m, 0.4, 0.4)):
        assert got.dtype == want.dtype
        npt.assert_array_equal(got, want)


def test_qm_rows_by_rank_and_rank_reorder_match_jax(rng):
    n, m = 57, 83
    z = rng.normal(size=(4, 2, n))
    y = rng.normal(size=(4, 2, m))
    lo, hi, w = JM._rank_bracket(n, m, 0.4, 0.4)
    ys = np.sort(y, axis=-1)
    want = JM._qm_rows_by_rank(jnp.asarray(z), jnp.asarray(ys), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(w))
    got = PM._qm_rows_by_rank(_t(z), _t(ys), *PM._rank_bracket_dev(n, m, 0.4, 0.4, torch.device("cpu"), torch.float64))
    for g, wnt in zip(got, want):
        _close(g, wnt)
    t = rng.normal(size=(4, 2, n))
    _close(PM.rank_reorder(_t(z), _t(t)), JM.rank_reorder(jnp.asarray(z), jnp.asarray(t)))


# ----------------------------------------------------------------------
# cores
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "C,m,n,p,d,kinds",
    [
        (4, 260, 240, 200, 3, ("difference",) * 3),
        (16, 730, 365, 500, 2, ("difference", "difference")),
        (6, 300, 420, 280, 3, ("difference", "ratio", "difference")),
        (5, 250, 250, 250, 2, ("ratio", "difference")),
    ],
)
def test_mbcn_correct_matches_jax(rng, C, m, n, p, d, kinds):
    pos = tuple(j for j, k in enumerate(kinds) if k == "ratio")
    y, xh, xf = _blocks(rng, C, m, n, p, d, positive=pos)
    R = JM.mbcn_rotations(d, 5, 0)
    want = JM.mbcn_correct(jnp.asarray(y), jnp.asarray(xh), jnp.asarray(xf), R, kinds=kinds)
    got = PM.mbcn_correct(_t(y), _t(xh), _t(xf), R, kinds=kinds)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float64
        _close(g, wnt)


def test_output_rows_are_permutations_of_the_margins(rng):
    """The closing reorder only permutes: each output row is exactly a
    permutation of the port's own QDM margin row."""
    kinds = ("difference", "ratio", "difference")
    y, xh, xf = _blocks(rng, 4, 300, 280, 260, 3, positive=(1,))
    R = PM.mbcn_rotations(3, 5, 0)
    oh, of = PM.mbcn_correct(_t(y), _t(xh), _t(xf), R, kinds=kinds)
    mh, mf = PM.mbcn_margins(_t(y), _t(xh), _t(xf), kinds=kinds)
    for out, marg in ((oh, mh), (of, mf)):
        npt.assert_array_equal(
            np.sort(out.transpose(-1, -2).numpy(), axis=-1), np.sort(marg.numpy(), axis=-1)
        )


def test_float32_on_the_cpu_runs_the_plain_kernels(rng):
    """float32 blocks on the CPU stay float32 and give rows that are
    permutations of their margins."""
    y, xh, xf = (a.astype(np.float32) for a in _blocks(rng, 3, 200, 210, 190, 2))
    kinds = ("difference",) * 2
    oh, of = PM.mbcn_correct(_t(y), _t(xh), _t(xf), PM.mbcn_rotations(2, 4, 1), kinds=kinds)
    assert oh.dtype == of.dtype == torch.float32
    mh, _ = PM.mbcn_margins(_t(y), _t(xh), _t(xf), kinds=kinds)
    npt.assert_array_equal(np.sort(oh.transpose(-1, -2).numpy(), axis=-1), np.sort(mh.numpy(), axis=-1))


def _rank_share_and_spearman(got, want):
    """(share of time steps whose rank in its (cell, variable) series
    differs, least Spearman correlation of such a series) of (C, T, d)."""
    def ranks(a):
        return np.argsort(np.argsort(a, axis=1, kind="stable"), axis=1, kind="stable")

    rg, rw = ranks(got), ranks(want)
    T = got.shape[1]
    spearman = 1.0 - 6.0 * ((rg - rw).astype(np.float64) ** 2).sum(axis=1) / (T * (T * T - 1.0))
    return float(np.mean(rg != rw)), float(spearman.min())


def test_float32_drift_from_float64_is_the_algorithms():
    """The rotation rounds amplify float32 near-tie swaps: after 20 rounds
    at 1,460 steps the JAX package's own float32 run has a fifth of its
    ranks elsewhere than its float64 run, and so has the port's, while the
    rank correlation stays near 1.  This is why chip_smoke.py holds the
    card's full-depth output to rank statistics, not element-wise."""
    rng = np.random.default_rng(0)
    y, xh, xf = (a.astype(np.float32) for a in _blocks(rng, 4, 1460, 1460, 1460, 3))
    R = JM.mbcn_rotations(3, 20, 0)
    kinds = ("difference",) * 3
    want = np.asarray(JM.mbcn_correct(*(jnp.asarray(a.astype(np.float64)) for a in (y, xh, xf)), R, kinds=kinds)[0])
    jax32 = np.asarray(JM.mbcn_correct(jnp.asarray(y), jnp.asarray(xh), jnp.asarray(xf), R, kinds=kinds)[0])
    port32 = PM.mbcn_correct(_t(y), _t(xh), _t(xf), R, kinds=kinds)[0].numpy()
    for got in (jax32, port32):
        share, spearman = _rank_share_and_spearman(got.astype(np.float64), want)
        assert share > 0.05 and spearman >= 0.995, (share, spearman)


def test_kinds_length_raises(rng):
    y, xh, xf = _blocks(rng, 2, 50, 50, 50, 2)
    with pytest.raises(ValueError, match="kinds has"):
        PM.mbcn_correct(_t(y), _t(xh), _t(xf), PM.mbcn_rotations(2, 2), kinds=("difference",))


def _daily_months(start, periods):
    return np.asarray(pd.date_range(start, periods=periods, freq="D").month)


def test_mbcn_correct_monthly_matches_jax(rng):
    mo, mh, mf = _daily_months("1981-01-01", 730), _daily_months("1984-01-01", 731), _daily_months("2050-03-01", 400)
    y, xh, xf = _blocks(rng, 3, 730, 731, 400, 2)
    R = JM.mbcn_rotations(2, 3, 0)
    kinds = ("difference",) * 2
    want = JM.mbcn_correct_monthly(
        jnp.asarray(y), jnp.asarray(xh), jnp.asarray(xf), mo, mh, mf, R, kinds=kinds
    )
    got = PM.mbcn_correct_monthly(_t(y), _t(xh), _t(xf), mo, mh, mf, R, kinds=kinds)
    for g, wnt in zip(got, want):
        _close(g, wnt)
    with pytest.raises(ValueError, match="absent"):
        PM.mbcn_correct_monthly(_t(y), _t(xh), _t(xf), mo[:100], mh, mf, R, kinds=kinds)


# ----------------------------------------------------------------------
# grid runner
# ----------------------------------------------------------------------


def _grids(rng, DA, DS, ny=3, nx=4, tm=180, to=200, tf=150):
    """Three two-variable Datasets with an all-NaN cell and, in the model
    blocks, one NaN sample in another cell (``tests/test_mbc.py``'s grids)."""

    def ds(T, loc, start, nan_sample):
        idx = pd.date_range(start, periods=T, freq="D")
        coords = {"time": idx, "y": np.arange(ny), "x": np.arange(nx)}
        das = {}
        for j, v in enumerate(("tmax", "pr")):
            a = np.random.default_rng(j + T).normal(loc + j, 1.5, (T, ny, nx))
            a[:, 0, 0] = np.nan  # ocean cell
            if nan_sample and j == 1:
                a[3, 2, 1] = np.nan
            das[v] = DA(a, ("time", "y", "x"), coords)
        return DS(das)

    return ds(to, 0.0, "1980-01-01", False), ds(tm, 1.0, "1981-01-01", True), ds(tf, 1.3, "2050-01-01", False)


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("group", [None, "month"])
def test_mbcn_grid_matches_jax_and_masks(rng, chunk, group):
    tm, to, tf = (360, 365, 180) if group else (180, 200, 150)
    jy, jxh, jxf = _grids(rng, JDA, JDS, tm=tm, to=to, tf=tf)
    py, pxh, pxf = _grids(rng, PDA, PDS, tm=tm, to=to, tf=tf)
    want = JM.mbcn_grid(jy, jxh, jxf, n_iterations=4, cell_chunk_size=chunk, group=group)
    got = PM.mbcn_grid(py, pxh, pxf, n_iterations=4, cell_chunk_size=chunk, group=group, device="cpu")
    for g, wnt in zip(got, want):
        assert isinstance(g, PDS) and set(g.data_vars) == {"tmax", "pr"}
        for v in ("tmax", "pr"):
            vals = g[v].values
            assert vals.dtype == np.float64
            assert np.isnan(vals[:, 0, 0]).all() and np.isnan(vals[:, 2, 1]).all()
            assert np.isfinite(vals).sum() == vals.shape[0] * 10
            _close(vals, wnt[v].values)
            assert g[v].dims == wnt[v].dims
    assert len(got[0]["tmax"].coords["time"]) == tm and len(got[1]["tmax"].coords["time"]) == tf


def test_mbcn_grid_errors(rng):
    py, pxh, pxf = _grids(rng, PDA, PDS)
    y2, _, _ = _grids(rng, PDA, PDS, ny=5)
    with pytest.raises(ValueError, match="spatial shapes"):
        PM.mbcn_grid(y2, pxh, pxf, n_iterations=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 A item 5"):
        PM.mbcn_grid(py, pxh, pxf, n_iterations=2, device="cpu", sharding=object())
    with pytest.raises(ValueError, match="group"):
        PM.mbcn_grid(py, pxh, pxf, n_iterations=2, device="cpu", group="season")


def test_mbcn_grid_on_the_card_raises_without_one(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test pins the behaviour without one")
    py, pxh, pxf = _grids(rng, PDA, PDS)
    with pytest.raises(RuntimeError, match="is_available"):
        PM.mbcn_grid(py, pxh, pxf, n_iterations=2)


# ----------------------------------------------------------------------
# sklearn wrapper and convert.py
# ----------------------------------------------------------------------


def _frames(rng, n=400, m=420, p=300):
    y, xh, xf = (a[0] for a in _blocks(rng, 1, m, n, p, 3))
    cols = ["tmax", "tmin", "pr"]
    ih = pd.date_range("1980-01-01", periods=n, freq="D")
    iy = pd.date_range("1979-01-01", periods=m, freq="D")
    i_f = pd.date_range("2050-01-01", periods=p, freq="D")
    return (pd.DataFrame(xh, index=ih, columns=cols), pd.DataFrame(y, index=iy, columns=cols),
            pd.DataFrame(xf, index=i_f, columns=cols))


@pytest.mark.parametrize("group", [None, "month"])
def test_wrapper_fit_predict_transform_match_jax(rng, group):
    X, Y, Xf = _frames(rng)
    jm = JM.MBCn(n_iterations=4, group=group, random_state=2).fit(X, Y)
    pm = P.MBCn(n_iterations=4, group=group, random_state=2).fit(X, Y)
    npt.assert_array_equal(pm.rotations_, jm.rotations_)
    got, want = pm.predict(Xf), jm.predict(Xf)
    assert list(got.columns) == ["tmax", "tmin", "pr"] and got.index.equals(Xf.index)
    _close(got.to_numpy(), want.to_numpy())
    _close(pm.transform(), jm.transform())
    # numpy input: grouping by month makes up a monthly-from-1950 index
    with pytest.warns(UserWarning) if group else contextlib.nullcontext():
        out = P.MBCn(n_iterations=2, group=group).fit(X.to_numpy(), Y.to_numpy()).predict(Xf.to_numpy())
    assert isinstance(out, np.ndarray) and out.shape == Xf.shape


def test_wrapper_errors(rng):
    from sklearn.base import clone

    X, Y, Xf = _frames(rng, n=120, m=130, p=90)
    xh, y = X.to_numpy(), Y.to_numpy()
    model = P.MBCn(n_iterations=3, kind="ratio", random_state=5)
    assert clone(model).get_params() == model.get_params()
    with pytest.raises(Exception):
        P.MBCn().predict(xh)  # not fitted
    with pytest.raises(ValueError, match="variables"):
        P.MBCn().fit(xh, y[:, :2])
    with pytest.raises(ValueError, match="kind"):
        P.MBCn(kind="bogus").fit(xh, y)
    with pytest.raises(ValueError, match="kind"):
        P.MBCn(kind=("difference",)).fit(xh, y)
    with pytest.raises(ValueError, match="group"):
        P.MBCn(group="season").fit(xh, y)
    bad = xh.copy()
    bad[3, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        P.MBCn(n_iterations=2).fit(bad, y)
    m = P.MBCn(n_iterations=2).fit(xh, y)
    fbad = Xf.to_numpy().copy()
    fbad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        m.predict(fbad)
    fbad[0, 0] = np.inf
    with pytest.raises(ValueError, match="infinity"):
        m.predict(fbad)
    with pytest.raises(ValueError, match="features"):
        m.predict(Xf.to_numpy()[:, :2])


@pytest.mark.parametrize("group", [None, "month"])
def test_mbcn_state_from_jax(rng, group):
    X, Y, Xf = _frames(rng)
    jm = JM.MBCn(n_iterations=3, kind=("difference", "difference", "difference"), group=group).fit(X, Y)
    pm = mbcn_state_from_jax(jm)
    assert isinstance(pm, P.MBCn) and pm.get_params() == jm.get_params()
    _close(pm.predict(Xf).to_numpy(), jm.predict(Xf).to_numpy())
    _close(pm.transform(), jm.transform())
