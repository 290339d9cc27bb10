"""The port's global (pooled) models (``global_models/``) and
``parallel/mesh.pad_to_multiple`` against the JAX package's on the CPU, in
float64: the pooled quantile ladder (exact and from weights), both linear
intercept modes, the mapper's transform / inverse_transform, and
``GlobalDownscaler`` on DataArrays and bare arrays; the sharded forms and
a card that is not there raise.

``GlobalQuantileMapper._map`` runs K6 (``ops/interp.interp_rows``, its
plain version here) where the JAX package runs ``interp_sortmerge``; the
two agree on valid data, knot ties and knot hits included
(:func:`test_map_agrees_with_sortmerge_at_ties_and_knot_hits`).

Tolerance: ``atol = 1e-10`` on values of order 1-300: the same float64
arithmetic summed in another order.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

import skdownscale_tpu.global_models as JGM
import skdownscale_tpu.global_models.quantile as JQ
from skdownscale_tpu import xlite as jxlite
from skdownscale_tpu.parallel import mesh as jmesh

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.global_models as PGM
import skdownscale_tpu_torch.global_models.quantile as PQ
from skdownscale_tpu_torch import xlite as pxlite
from skdownscale_tpu_torch.convert import (
    global_linear_state_from_jax,
    global_quantile_state_from_jax,
    state_to_numpy,
)
from skdownscale_tpu_torch.parallel import mesh as pmesh

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


def _lin_data(rng, C=24, T=200, f=3, nan_frac=0.1):
    X = rng.normal(0, 1, (C, T, f))
    coef = np.array([1.5, -0.7, 0.3][:f])
    y = X @ coef + rng.normal(0, 2, (C, 1)) + 5.0 + rng.normal(0, 0.05, (C, T))
    if nan_frac > 0:
        y[rng.random((C, T)) < nan_frac] = np.nan
        X[rng.random((C, T, f)) < 0.02] = np.nan
    y[3] = np.nan  # an all-NaN (ocean) cell
    return X, y


def _q_data(rng, C=16, T=300, step=None):
    obs = rng.gamma(2.0, 1.5, (C, T))
    model = obs * 1.3 + 0.8 + rng.normal(0, 0.2, (C, T))
    if step is not None:  # quantized data: tied ladder values
        obs, model = np.round(obs / step) * step, np.round(model / step) * step
    model[2] = np.nan
    model[5, :40] = np.nan
    obs[7, 10:20] = np.nan
    return model, obs


@pytest.mark.parametrize("nq", [1, 7, 512, 2048])
def test_ladder_positions_bitwise(nq):
    npt.assert_array_equal(PQ.ladder_positions(nq).numpy(), np.asarray(JQ.ladder_positions(nq)))


@pytest.mark.parametrize("step", [None, 0.5])
@pytest.mark.parametrize("nq", [64, 1000])
def test_pooled_ladder_matches_jax(rng, step, nq):
    model, _ = _q_data(rng, step=step)
    pp = JQ.ladder_positions(nq)
    lad, n = PQ.pooled_quantile_table(torch.from_numpy(model), torch.tensor(np.asarray(pp)))
    jlad, jn = JQ.pooled_quantile_table(jnp.asarray(model), pp)
    _close(lad, jlad)
    assert int(n) == int(jn) == int(np.isfinite(model).sum())


def test_ladder_from_weighted_matches_jax(rng):
    """The weighted form (the sketch's merge): unsorted samples with real
    weights, zero-weight +inf pads."""
    vals = rng.normal(10, 3, 500)
    w = rng.uniform(0.5, 3.0, 500)
    vals[-20:], w[-20:] = np.inf, 0.0
    pp = JQ.ladder_positions(128)
    got = PQ._ladder_from_weighted(torch.from_numpy(vals), torch.from_numpy(w),
                                   torch.tensor(np.asarray(pp)))
    _close(got, JQ._ladder_from_weighted(jnp.asarray(vals), jnp.asarray(w), pp))


def test_empty_grid_ladder_is_nan():
    pp = PQ.ladder_positions(16)
    lad, n = PQ.pooled_quantile_table(torch.full((3, 10), float("nan"), dtype=torch.float64), pp)
    assert int(n) == 0 and bool(torch.isnan(lad).all())


@pytest.mark.parametrize("cell_intercepts", [False, True])
@pytest.mark.parametrize("f", [1, 3])
def test_global_linear_matches_jax(rng, cell_intercepts, f):
    X, y = _lin_data(rng, f=f)
    jm = JGM.GlobalLinearRegressor(cell_intercepts=cell_intercepts).fit(X, y)
    pm = PGM.GlobalLinearRegressor(cell_intercepts=cell_intercepts, device="cpu").fit(X, y)
    for a, b in zip(pm.state_, jm.state_):
        _close(a.to(torch.float64), np.asarray(b, dtype=np.float64))
    _close(pm.predict(X), jm.predict(X))
    assert pm.score(X, y) == pytest.approx(jm.score(X, y), abs=1e-12)
    # a 2-D X is one cell
    _close(pm.predict(X[0]), jm.predict(X[0]))


@pytest.mark.parametrize("step", [None, 0.5])
def test_global_quantile_mapper_matches_jax(rng, step):
    model, obs = _q_data(rng, step=step)
    jm = JGM.GlobalQuantileMapper(n_quantiles=256).fit(model, obs)
    pm = PGM.GlobalQuantileMapper(n_quantiles=256, device="cpu").fit(model, obs)
    for a, b in zip(pm.state_, jm.state_):
        _close(a.to(torch.float64), np.asarray(b, dtype=np.float64))
    _close(pm.transform(model), jm.transform(model))
    _close(pm.inverse_transform(obs), jm.inverse_transform(obs))
    # the default ladder size: min(2048, the pooled sample count)
    small = model[:, :50]
    _close(PGM.GlobalQuantileMapper(device="cpu").fit(small, obs[:, :50]).transform(small),
           JGM.GlobalQuantileMapper().fit(small, obs[:, :50]).transform(small))


def test_map_agrees_with_sortmerge_at_ties_and_knot_hits(rng):
    """K6's plain version (``interp_ramp``'s semantics) against the JAX
    ``interp_sortmerge`` on a shared tied ladder, with queries on every knot,
    between tied knots and past both ends: bitwise on valid data (no F9)."""
    from skdownscale_tpu.ops.interp import interp_sortmerge

    src = np.sort(np.round(rng.normal(0, 2, 300) * 2) / 2)  # ties
    dst = np.sort(rng.normal(1, 3, 300))
    q = np.concatenate([src, src + 0.25, [-50.0, 50.0], rng.normal(0, 3, 97)])[None, :].repeat(3, 0)
    got = PQ.GlobalQuantileMapper(device="cpu")._map(
        torch.from_numpy(q), torch.from_numpy(src), torch.from_numpy(dst))
    C, L = q.shape[0], src.size
    want = interp_sortmerge(jnp.broadcast_to(jnp.asarray(src), (C, L)),
                            jnp.broadcast_to(jnp.asarray(dst), (C, L)), jnp.asarray(q))
    npt.assert_array_equal(got.numpy(), np.asarray(want))


def test_jax_fitted_states_map_the_same_in_the_port(rng):
    model, obs = _q_data(rng)
    jm = JGM.GlobalQuantileMapper(n_quantiles=128).fit(model, obs)
    pm = PGM.GlobalQuantileMapper(device="cpu")
    pm.state_ = global_quantile_state_from_jax(*(np.asarray(a) for a in jm.state_), device="cpu")
    for a, b in zip(state_to_numpy(pm.state_), jm.state_):
        npt.assert_array_equal(a, np.asarray(b))
    _close(pm.transform(model), jm.transform(model))
    X, y = _lin_data(rng)
    jl = JGM.GlobalLinearRegressor(cell_intercepts=True).fit(X, y)
    pl = PGM.GlobalLinearRegressor(cell_intercepts=True, device="cpu")
    pl.state_ = global_linear_state_from_jax(*(np.asarray(a) for a in jl.state_), device="cpu")
    _close(pl.predict(X), jl.predict(X))


@pytest.mark.parametrize("kind", ["quantile", "linear"])
def test_global_downscaler_matches_jax_on_dataarrays(rng, kind):
    ny, nx, T = 4, 6, 150
    data = rng.normal(10, 3, (T, ny, nx))
    data[:, 0, 0] = np.nan  # ocean cell
    obs = data * 0.9 - 1.0 + rng.normal(0, 0.1, (T, ny, nx))
    dims = ("time", "y", "x")
    coords = {"time": np.arange(T), "y": np.arange(ny), "x": np.arange(nx)}

    def make(pkg):
        return pkg.GlobalQuantileMapper(n_quantiles=128) if kind == "quantile" else pkg.GlobalLinearRegressor()

    jd = JGM.GlobalDownscaler(make(JGM)).fit(jxlite.DataArray(data, dims, coords),
                                            jxlite.DataArray(obs, dims, coords))
    pd_ = PGM.GlobalDownscaler(make(PGM), device="cpu").fit(pxlite.DataArray(data, dims, coords),
                                                           pxlite.DataArray(obs, dims, coords))
    method = "transform" if kind == "quantile" else "predict"
    want = getattr(jd, method)(jxlite.DataArray(data, dims, coords))
    got = getattr(pd_, method)(pxlite.DataArray(data, dims, coords))
    assert isinstance(got, pxlite.DataArray) and got.dims == want.dims == ("y", "x", "time")
    _close(got.values, want.values)
    for name in ("y", "x", "time"):
        npt.assert_array_equal(np.asarray(got.coords[name]), np.asarray(want.coords[name]))
    if kind == "quantile":
        _close(pd_.inverse_transform(pxlite.DataArray(obs, dims, coords)).values,
               jd.inverse_transform(jxlite.DataArray(obs, dims, coords)).values)


def test_global_downscaler_matches_jax_on_bare_arrays(rng):
    C, T = 20, 80
    X = rng.normal(0, 1, (C, T))
    y = 2.0 * X + 1.0 + rng.normal(0, 0.01, (C, T))
    got = PGM.GlobalDownscaler(PGM.GlobalLinearRegressor(), device="cpu").fit(X, y).predict(X)
    want = JGM.GlobalDownscaler(JGM.GlobalLinearRegressor()).fit(X, y).predict(X)
    assert isinstance(got, np.ndarray) and got.shape == (C, T)
    _close(got, want)
    got = PGM.GlobalDownscaler(PGM.GlobalQuantileMapper(), device="cpu").fit(X, y).transform(X[0])
    want = JGM.GlobalDownscaler(JGM.GlobalQuantileMapper()).fit(X, y).transform(X[0])
    _close(got, want)


def test_sharded_forms_and_a_missing_card_raise(rng, monkeypatch):
    """The sharded forms run (``tests/test_torch_mesh.py`` holds them
    against the JAX package's); a missing card raises."""
    X = rng.normal(0, 1, (4, 30))
    two = pmesh.cell_mesh(["cpu", "cpu"])
    y = 2.0 * X + 1.0
    lin = PGM.GlobalDownscaler(PGM.GlobalLinearRegressor(), sharding=two).fit(X, y)
    _close(lin.predict(X), PGM.GlobalDownscaler(PGM.GlobalLinearRegressor(), device="cpu").fit(X, y).predict(X))
    # each shard holds 60 samples: a sketch of 60 a shard takes every one
    # of them at weight 1, which is the exact ladder
    exact = PGM.GlobalQuantileMapper(device="cpu").fit(X, X).state_.x_ladder
    sk = PGM.GlobalQuantileMapper(mesh=two, sample_per_shard=60, device="cpu").fit(X, X)
    assert int(sk.state_.n_x) == X.size
    _close(sk.state_.x_ladder, exact)
    lad, n = PQ.pooled_quantile_table(torch.from_numpy(X), PQ.ladder_positions(8), two, sample_per_shard=60)
    _close(lad, PQ.pooled_quantile_table(torch.from_numpy(X), PQ.ladder_positions(8))[0])
    assert int(n) == X.size
    # a mesh of one device is the one-device fit
    one = PGM.GlobalQuantileMapper(mesh=pmesh.cell_mesh(["cpu"]), device="cpu").fit(X, X)
    _close(one.transform(X), PGM.GlobalQuantileMapper(device="cpu").fit(X, X).transform(X))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: PGM.GlobalLinearRegressor().fit(X[..., None], X),
                 lambda: PGM.GlobalQuantileMapper().fit(X, X),
                 lambda: PGM.GlobalDownscaler(PGM.GlobalQuantileMapper(device="cpu")).fit(X, X)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert P.GlobalDownscaler is PGM.GlobalDownscaler


@pytest.mark.parametrize("n,multiple", [(20, 8), (16, 8), (5, 1), (7, 3)])
def test_pad_to_multiple_bitwise(rng, n, multiple):
    a = rng.normal(size=(n, 3))
    (got, gn), (want, wn) = pmesh.pad_to_multiple(a, multiple), jmesh.pad_to_multiple(a, multiple)
    assert gn == wn == n
    npt.assert_array_equal(got, want)
    (got, _), (want, _) = pmesh.pad_to_multiple(a, 4, axis=1, fill=0.0), jmesh.pad_to_multiple(a, 4, axis=1, fill=0.0)
    npt.assert_array_equal(got, want)
