"""The port's GARD family against the JAX package on the CPU, in float64:
the batched cores (the plain versions of K7 and K8 + ``_ar_finish``, and
the torch route for tensors outside the kernels' gates), PureRegression,
the single-cell wrappers, ``PointWiseDownscaler`` with its three outputs,
and fitted state carried across packages by ``convert.py``.

Tolerance: ``atol = 1e-10`` on values of order 15 (the same float64
arithmetic in another order: sums over the analogs, small solves, 8 Newton
steps).  The port's AnalogRegression takes the kernel's route (sufficient
statistics over centred x, then ``_ar_finish``) where the JAX package's CPU
route gathers the analogs and fits each query; the two agree to about
1e-14 for the same selected analogs.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import skdownscale_tpu as J
import skdownscale_tpu.models.batched as jb
import skdownscale_tpu.models.gard as jg
from skdownscale_tpu.xlite import DataArray as JDA
from skdownscale_tpu.xlite import Dataset as JDS

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.models.gard as pg
from skdownscale_tpu_torch.convert import (
    gard_state_from_jax,
    pure_regression_state_from_jax,
    state_to_numpy,
)
from skdownscale_tpu_torch.models import batched as pb
from skdownscale_tpu_torch.models.base import SingleCellEstimator
from skdownscale_tpu_torch.xlite import DataArray as PDA
from skdownscale_tpu_torch.xlite import Dataset as PDS

ATOL = 1e-10
KINDS = ["best_analog", "sample_analogs", "weight_analogs", "mean_analogs"]


@pytest.fixture(autouse=True)
def single_cell_on_cpu(monkeypatch):
    """The single-cell API runs on the card by default; these tests ask for
    the CPU (float64)."""
    monkeypatch.setattr(SingleCellEstimator, "single_cell_device", torch.device("cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_allclose(got, want, rtol=0, atol=atol)


def _data(rng, C, n, m, f):
    """bench.py's GARD data: X ~ N(10, 3), y = 0.2 N(10, 3) + 13."""
    Xt = rng.normal(10, 3, (C, n, f))
    yt = 0.2 * rng.normal(10, 3, (C, n)) + 13
    Xq = rng.normal(10, 3, (C, m, f))
    return Xt, yt, Xq


# ----------------------------------------------------------------------
# batched cores
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("thresh", [None, 13.0, 15.0])
def test_pure_analog_batched_matches_jax(rng, kind, thresh):
    """Both routes of the port (plain K7, and the torch route taken on the
    card outside the kernel's gates) against the JAX package's vmapped core,
    with the same ``rand``."""
    Xt, yt, Xq = _data(rng, 3, 60, 19, 2)
    k = 1 if kind == "best_analog" else 15
    rand = rng.integers(0, k, (3, 19)).astype(np.int32)
    fn = lambda a, b, c, r: jg.pure_analog_predict(a, b, c, r, k=k, kind=kind, thresh=thresh)
    want = jax.vmap(fn)(*map(jnp.asarray, (Xt, yt, Xq, rand)))
    args = tuple(map(_t, (Xt, yt, Xq, rand)))
    _same(pg.pure_analog_predict_batched(*args, k=k, kind=kind, thresh=thresh), want)
    _same(pg.pure_analog_predict(*args, k=k, kind=kind, thresh=thresh), want)


@pytest.mark.parametrize("f", [1, 5])
def test_pure_analog_batched_matches_jax_other_widths(rng, f):
    """One and five features (the JAX kNN's expanded form above four)."""
    Xt, yt, Xq = _data(rng, 2, 50, 11, f)
    rand = np.zeros((2, 11), np.int32)
    for kind in ("weight_analogs", "mean_analogs"):
        fn = lambda a, b, c, r: jg.pure_analog_predict(a, b, c, r, k=9, kind=kind, thresh=15.0)
        want = jax.vmap(fn)(*map(jnp.asarray, (Xt, yt, Xq, rand)))
        got = pg.pure_analog_predict_batched(*map(_t, (Xt, yt, Xq, rand)), k=9, kind=kind, thresh=15.0)
        _same(got, want)


@pytest.mark.parametrize("f", [1, 2, 3, 5])
@pytest.mark.parametrize("thresh", [None, 15.0])
def test_analog_regression_batched_matches_jax(rng, f, thresh):
    """Plain K8 + ``_ar_finish`` and the torch route against the JAX
    package's gather core (kNN, pinv OLS, logistic fit per query).  k = 40
    keeps the local logistic fits away from separable analog sets, where
    8 Newton steps are far from converged and rounding differences of
    1e-16 grow through the ill-conditioned steps."""
    Xt, yt, Xq = _data(rng, 2, 90, 13, f)
    fn = lambda a, b, c: jg.analog_regression_predict(a, b, c, k=40, thresh=thresh)
    want = jax.vmap(fn)(*map(jnp.asarray, (Xt, yt, Xq)))
    args = tuple(map(_t, (Xt, yt, Xq)))
    _same(pg.analog_regression_predict_batched(*args, k=40, thresh=thresh), want)
    _same(pg.analog_regression_predict(*args, k=40, thresh=thresh), want)


def test_ar_finish_matches_jax(rng):
    """``_ar_finish`` on the same sufficient statistics, incl. a cell whose
    queries have no exceeding analog (NaN pred and error)."""
    from skdownscale_tpu_torch.kernels import knn as KN

    Xt, yt, Xq = _data(rng, 2, 60, 9, 2)
    yt[0] = 10.0
    stats, prob, mu, ybar = KN.analog_regression_stats(*map(_t, (Xt, yt, Xq)), k=30, thresh=15.0)
    finish = jax.jit(jg._ar_finish, static_argnums=5)
    want = finish(*(jnp.asarray(t.numpy()) for t in (stats, prob, mu, ybar)), jnp.asarray(Xq), 2)
    got = pg._ar_finish(stats, prob, mu, ybar, _t(Xq), 2)
    assert torch.isnan(got[0, :, 0]).all() and torch.isfinite(got[1]).all()
    _same(got, want)


@pytest.mark.parametrize("f", [1, 2, 3])
@pytest.mark.parametrize("thresh", [None, 15.0])
def test_pure_regression_matches_jax(rng, f, thresh):
    """Fit and predict, batched; f = 3 takes the eigh pinv.  With a
    threshold the last cell has one class (every target exceeds): no
    logistic model there."""
    Xt, yt, Xq = _data(rng, 3, 80, 17, f)
    if thresh is not None:
        yt[-1] = 16.0 + rng.random(80)
    jfit = jax.vmap(lambda a, b: jg.pure_regression_fit(a, b, thresh=thresh))
    jstate = jfit(jnp.asarray(Xt), jnp.asarray(yt))
    want = jax.vmap(jg.pure_regression_predict)(jstate, jnp.asarray(Xq))
    state = pg.pure_regression_fit(_t(Xt), _t(yt), thresh=thresh)
    for got_field, want_field in zip(state, jstate):
        _same(got_field, want_field)
    _same(pg.pure_regression_predict(state, _t(Xq)), want)
    if thresh is not None:
        assert state.has_logistic.tolist() == [True, True, False]


# ----------------------------------------------------------------------
# single-cell wrappers
# ----------------------------------------------------------------------


def _frames(rng, n=120, m=40, f=2):
    idx = pd.date_range("1990-01-01", periods=n, freq="D")
    qidx = pd.date_range("2000-01-01", periods=m, freq="D")
    cols = [f"v{j}" for j in range(f)]
    X = pd.DataFrame(rng.normal(10, 3, (n, f)), index=idx, columns=cols)
    y = pd.Series(0.2 * rng.normal(10, 3, n) + 13, index=idx)
    Xq = pd.DataFrame(rng.normal(10, 3, (m, f)), index=qidx, columns=cols)
    return X, y, Xq


@pytest.mark.parametrize("kind", KINDS)
def test_pure_analog_wrapper_matches_jax(rng, kind):
    X, y, Xq = _frames(rng)
    kw = dict(n_analogs=25, kind=kind, thresh=15.0, random_state=7)
    got = P.PureAnalog(**kw).fit(X, y).predict(Xq)
    want = J.PureAnalog(**kw).fit(X, y).predict(Xq)
    assert isinstance(got, pd.DataFrame) and list(got.columns) == list(want.columns)
    _same(got.to_numpy(), want.to_numpy())
    # arrays in, arrays out
    arr = P.PureAnalog(**kw).fit(X.to_numpy(), y.to_numpy()).predict(Xq.to_numpy())
    assert isinstance(arr, np.ndarray)
    _same(arr, want.to_numpy())


def test_gard_wrappers_match_jax_and_warn(rng):
    X, y, Xq = _frames(rng, n=30)
    # the k_ clamp: fewer rows than n_analogs
    with pytest.warns(UserWarning, match="setting n_analogs = len"):
        ar = P.AnalogRegression(n_analogs=50, thresh=15.0).fit(X, y)
    with pytest.warns(UserWarning, match="setting n_analogs = len"):
        jar = J.AnalogRegression(n_analogs=50, thresh=15.0).fit(X, y)
    assert ar.k_ == jar.k_ == 30
    _same(ar.predict(Xq).to_numpy(), jar.predict(Xq).to_numpy())
    # kdtree_ stand-in: distances and indices as the JAX package's
    gd, gi = ar.kdtree_.query(Xq, k=5)
    wd, wi = jar.kdtree_.query(Xq, k=5)
    npt.assert_array_equal(gi, wi)
    _same(gd, wd)
    npt.assert_array_equal(ar.kdtree_.query(Xq, k=5, return_distance=False), wi)
    # PureRegression: the one-class fallback sets thresh_, leaves thresh
    yy = y + 10.0
    with pytest.warns(UserWarning, match="only one class"):
        pr = P.PureRegression(thresh=15.0).fit(X, yy)
    with pytest.warns(UserWarning, match="only one class"):
        jpr = J.PureRegression(thresh=15.0).fit(X, yy)
    assert pr.thresh == 15.0 and pr.thresh_ is None and pr.logistic_model_ is None
    _same(pr.predict(Xq).to_numpy(), jpr.predict(Xq).to_numpy())
    with pytest.raises(ValueError, match="below thresh"):
        P.PureRegression(thresh=1e9).fit(X, y)
    # with two classes: the fitted attributes as the JAX package's
    pr = P.PureRegression(thresh=15.0).fit(X, y)
    jpr = J.PureRegression(thresh=15.0).fit(X, y)
    assert pr.thresh_ == 15.0
    _same(pr.linear_model_["coef_"], jpr.linear_model_["coef_"])
    _same(pr.logistic_model_["coef_"], jpr.logistic_model_["coef_"])
    npt.assert_allclose(pr.fit_error_, jpr.fit_error_, rtol=0, atol=ATOL)
    _same(pr.predict(Xq.to_numpy()), jpr.predict(Xq.to_numpy()))
    with pytest.raises(ValueError, match="unexpected kind"):
        P.PureAnalog(n_analogs=5, kind="median").fit(X, y).predict(Xq)


def test_sample_analogs_global_rng_draw(rng):
    """``random_state=None`` draws from numpy's global generator, as the
    JAX package's wrapper does."""
    X, y, Xq = _frames(rng)
    np.random.seed(3)
    got = P.PureAnalog(n_analogs=10, kind="sample_analogs").fit(X, y).predict(Xq)
    np.random.seed(3)
    want = J.PureAnalog(n_analogs=10, kind="sample_analogs").fit(X, y).predict(Xq)
    _same(got.to_numpy(), want.to_numpy())


# ----------------------------------------------------------------------
# PointWiseDownscaler
# ----------------------------------------------------------------------


def _grid(rng, C=10, T=150, Tq=40, f=2):
    """(time, cell) Datasets of f variables; cells 2 and 7 are NaN."""
    idx = pd.date_range("1990-01-01", periods=T, freq="D")
    qidx = pd.date_range("2001-01-01", periods=Tq, freq="D")
    xs = [rng.normal(10, 3, (T, C)) for _ in range(f)]
    qs = [rng.normal(10, 3, (Tq, C)) for _ in range(f)]
    y = 0.2 * rng.normal(10, 3, (T, C)) + 13
    for a in (*xs, *qs, y):
        a[:, [2, 7]] = np.nan

    def build(DA, DS):
        c, cq = {"time": idx, "cell": np.arange(C)}, {"time": qidx, "cell": np.arange(C)}
        dims = ("time", "cell")
        X = DS({f"v{j}": DA(a, dims, c) for j, a in enumerate(xs)})
        Xq = DS({f"v{j}": DA(a, dims, cq) for j, a in enumerate(qs)})
        return X, DA(y, dims, c), Xq

    return build(PDA, PDS), build(JDA, JDS)


_GRID_MODELS = {
    "mean": lambda M: M.PureAnalog(n_analogs=12, kind="mean_analogs", thresh=15.0),
    "sample": lambda M: M.PureAnalog(n_analogs=12, kind="sample_analogs", random_state=5),
    "regression": lambda M: M.AnalogRegression(n_analogs=40, thresh=15.0),  # see the k = 40 note above
    "pure_regression": lambda M: M.PureRegression(thresh=15.0),
}


@pytest.mark.parametrize("name", list(_GRID_MODELS))
@pytest.mark.parametrize("chunk", [None, 3])
def test_pointwise_matches_jax_runner(rng, name, chunk):
    """Three outputs as (time, variable, cell) with the output names as the
    coordinate, NaN cells NaN, equal to the JAX runner with the same
    ``cell_chunk_size`` (sample analogs draw per chunk in both)."""
    (X, Y, Xq), (jX, jY, jXq) = _grid(rng)
    got = P.PointWiseDownscaler(_GRID_MODELS[name](P), device="cpu", cell_chunk_size=chunk).fit(X, Y)
    want = J.PointWiseDownscaler(_GRID_MODELS[name](J), cell_chunk_size=chunk).fit(jX, jY)
    out, jout = got.predict(Xq), want.predict(jXq)
    assert out.dims == jout.dims == ("time", "variable", "cell")
    assert list(out.coords["variable"]) == ["pred", "exceedance_prob", "prediction_error"]
    assert np.isnan(out.values[:, :, [2, 7]]).all()
    _same(out.values, jout.values)
    key = "fit_error_" if name == "pure_regression" else "k_"
    _same(got.get_attr(key).values, want.get_attr(key).values)
    if chunk and name != "sample":  # chunks equal one pass
        one = P.PointWiseDownscaler(_GRID_MODELS[name](P), device="cpu").fit(X, Y).predict(Xq)
        _same(out.values, one.values, atol=1e-12)


def test_pointwise_k_clamp_warns_as_jax(rng):
    (X, Y, Xq), (jX, jY, jXq) = _grid(rng, T=40)
    with pytest.warns(UserWarning, match="setting n_analogs = len"):
        got = P.PointWiseDownscaler(P.PureAnalog(n_analogs=60, kind="mean_analogs"), device="cpu").fit(X, Y)
    with pytest.warns(UserWarning, match="setting n_analogs = len"):
        want = J.PointWiseDownscaler(J.PureAnalog(n_analogs=60, kind="mean_analogs")).fit(jX, jY)
    assert got._model.k_ == 40
    _same(got.predict(Xq).values, want.predict(jXq).values)


def test_multivariable_dataset_analog_regression(rng):
    """The JAX package's tests/test_pointwise_runner.py:183-197 on the port:
    a two-variable Dataset packs as (cells, time, 2)."""
    idx = pd.date_range("1990-01-01", "1995-12-01", freq="MS")
    T, Pn = len(idx), 4
    coords = {"time": idx, "point": np.arange(Pn)}
    a, b = 280 + rng.normal(0, 2, (T, Pn)), rng.normal(0, 1, (T, Pn))
    yv = 281 + rng.normal(0, 2, (T, Pn))
    ds = PDS({"ta": PDA(a, ("time", "point"), coords), "u": PDA(b, ("time", "point"), coords)})
    d = P.PointWiseDownscaler(P.AnalogRegression(n_analogs=12), device="cpu")
    out = d.fit(ds, PDA(yv, ("time", "point"), coords)).predict(ds)
    assert out.dims == ("time", "variable", "point")
    assert out.sizes["variable"] == 3
    assert np.isfinite(out.values).all()
    jds = JDS({"ta": JDA(a, ("time", "point"), coords), "u": JDA(b, ("time", "point"), coords)})
    want = J.PointWiseDownscaler(J.AnalogRegression(n_analogs=12)).fit(jds, JDA(yv, ("time", "point"), coords))
    _same(out.values, want.predict(jds).values)


# ----------------------------------------------------------------------
# convert.py
# ----------------------------------------------------------------------


def test_gard_states_cross_packages(rng):
    """A GARD and a PureRegression state fitted by the JAX registry predict
    the same in the port, and come back as the same numpy arrays."""
    Xt, yt, Xq = _data(rng, 4, 60, 9, 2)
    pa = J.PureAnalog(n_analogs=10, kind="weight_analogs", thresh=15.0)
    jstate = jb.batched_fit(pa, None, jnp.asarray(Xt), jnp.asarray(yt))
    want = jb.batched_predict(pa, jstate, None, jnp.asarray(Xq), None)
    fields = [np.asarray(a) for a in jstate]
    state = gard_state_from_jax(*fields)
    ppa = P.PureAnalog(n_analogs=10, kind="weight_analogs", thresh=15.0)
    ppa.k_ = pa.k_
    _same(pb.batched_predict(ppa, state, None, _t(Xq), None), want)
    for back, orig in zip(state_to_numpy(state), fields):
        npt.assert_array_equal(back, orig)

    prm = J.PureRegression(thresh=15.0)
    jstate = jb.batched_fit(prm, None, jnp.asarray(Xt), jnp.asarray(yt))
    fields = [np.asarray(a) for a in jstate]
    state = pure_regression_state_from_jax(*fields)
    assert state.has_logistic.dtype == torch.bool
    want = jb.batched_predict(prm, jstate, None, jnp.asarray(Xq), None)
    _same(pb.batched_predict(P.PureRegression(thresh=15.0), state, None, _t(Xq), None), want)
    for back, orig in zip(state_to_numpy(state), fields):
        npt.assert_array_equal(back, orig)
