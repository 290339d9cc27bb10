"""The port's kNN, regression ops and the plain versions of the fused GARD
kernels (K7, K8) against the JAX package on the CPU.

* ``ops/knn.py`` and ``ops/regression.py`` against their JAX counterparts
  in float64, within 1e-10 (the same arithmetic in another order); the
  neighbour indices exactly, including the lower-index-first tie order.
* plain K7 against ``pure_analog_stats(interpret=True)`` and plain K8 +
  ``_ar_finish`` against ``analog_regression_predict_batched(
  force_kernel=True, interpret=True)`` in float32, at the shapes and within
  the tolerances of the JAX package's own ``tests/test_knn_kernel.py``
  (the Pallas kernel takes distances by the expanded form and sums its
  Newton steps on the matrix unit, the port by the direct form and
  elementwise reductions).  The shapes are that file's, so its compiled
  Pallas programs are reused.
"""

import importlib

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

import skdownscale_tpu.models.gard as jg
import skdownscale_tpu.ops.regression as jr
from skdownscale_tpu.ops.knn import knn as jax_knn
from skdownscale_tpu.ops.pallas.knn_kernel import pure_analog_stats as pallas_pure_analog_stats

import skdownscale_tpu_torch.models.gard as pg
pknn = importlib.import_module("skdownscale_tpu_torch.ops.knn")  # ops.knn is the function
import skdownscale_tpu_torch.ops.regression as pr
from skdownscale_tpu_torch.kernels import knn as KN

ATOL = 1e-10


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gard_data(rng, C, n, m, f, dtype=np.float64):
    Xt = rng.normal(10, 3, (C, n, f)).astype(dtype)
    yt = (0.2 * rng.normal(10, 3, (C, n)) + 13).astype(dtype)
    Xq = rng.normal(10, 3, (C, m, f)).astype(dtype)
    return Xt, yt, Xq


# ----------------------------------------------------------------------
# ops/knn.py
# ----------------------------------------------------------------------


@pytest.mark.parametrize("f", [1, 2, 5])
@pytest.mark.parametrize("query_chunk", [None, 8])
def test_knn_matches_jax(rng, f, query_chunk):
    """Direct form up to 4 features, expanded above; duplicated training
    rows give exact ties, resolved toward the lower index in both.  Queries
    on training points (zero distances) only for the direct form: the
    expanded form leaves a rounding residue there that depends on the
    order of its sums."""
    Xt, _, Xq = _gard_data(rng, 1, 60, 21, f)
    Xt[0, 30:] = Xt[0, :30]
    if f <= 4:
        Xq[0, :5] = Xt[0, 40:45]
    want_d, want_i = jax_knn(jnp.asarray(Xt[0]), jnp.asarray(Xq[0]), 12, query_chunk=query_chunk)
    got_d, got_i = pknn.knn(_t(Xt), _t(Xq), 12, query_chunk=query_chunk)
    npt.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
    npt.assert_allclose(got_d[0].numpy(), np.asarray(want_d), rtol=0, atol=ATOL)
    inds = pknn.knn(_t(Xt), _t(Xq), 12, return_distance=False, query_chunk=query_chunk)
    npt.assert_array_equal(inds.numpy(), got_i.numpy())


def test_select_smallest_is_topk_order():
    d2 = torch.tensor([[3.0, 1.0, 2.0, 1.0, 0.5, 1.0]])
    vals, inds = pknn.select_smallest(d2, 4)
    assert inds.tolist() == [[4, 1, 3, 5]]
    neg, want = jax.lax.top_k(-jnp.asarray(d2.numpy()), 4)
    assert np.asarray(want).tolist() == inds.tolist()
    npt.assert_array_equal(vals.numpy(), -np.asarray(neg))


# ----------------------------------------------------------------------
# ops/regression.py
# ----------------------------------------------------------------------


@pytest.mark.parametrize("f", [1, 2, 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rank_deficient", [False, True])
def test_linreg_fit_predict_rmse_match_jax(rng, f, weighted, rank_deficient):
    """Batched linreg_fit against the vmapped JAX one: the analytic 1x1 and
    2x2 pinv and eigh from 3x3 up, including a duplicated column (the
    minimum-norm solution)."""
    B, n = 5, 40
    X = rng.normal(0, 2, (B, n, f))
    if rank_deficient and f > 1:
        X[..., -1] = X[..., 0]
    if rank_deficient and f == 1:
        X[1] = 3.0  # a constant column: zero-variance design
    y = X.sum(axis=-1) + rng.normal(0, 1, (B, n))
    w = (rng.random((B, n)) < 0.7).astype(float) if weighted else None

    def jfit(a, b, c=None):
        coef, icpt = jr.linreg_fit(a, b, c)
        return coef, icpt, jr.rmse(b, jr.linreg_predict(coef, icpt, a), c)

    jargs = (jnp.asarray(X), jnp.asarray(y)) + ((jnp.asarray(w),) if weighted else ())
    want = jax.vmap(jfit)(*jargs)
    coef, icpt = pr.linreg_fit(_t(X), _t(y), _t(w) if weighted else None)
    err = pr.rmse(_t(y), pr.linreg_predict(coef, icpt, _t(X)), _t(w) if weighted else None)
    for g, wv in zip((coef, icpt, err), want):
        npt.assert_allclose(g.numpy(), np.asarray(wv), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["generic", "degenerate", "singular"])
def test_psolve_2x2_matches_jax(case):
    G = np.array([[[4.0, 1.0], [1.0, 3.0]], [[2.0, 0.0], [0.0, 2.0]], [[1.0, 2.0], [2.0, 4.0]]])
    G = G[["generic", "degenerate", "singular"].index(case)][None]
    b = np.array([[1.0, -2.0]])
    want = jax.vmap(jr._psolve)(jnp.asarray(G), jnp.asarray(b))
    npt.assert_allclose(pr._psolve(_t(G), _t(b)).numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("f", [1, 2, 3])
def test_logistic_fit_matches_jax(rng, f):
    """Damped Newton with the closed-form 2x2 and 3x3 solves (f = 1, 2) and
    torch.linalg.solve from 4x4 (f = 3)."""
    B, n = 4, 60
    X = rng.normal(0, 1, (B, n, f))
    y = (X[..., 0] + rng.normal(0, 1, (B, n)) > 0).astype(float)
    want = jax.vmap(lambda a, b: jr.logistic_fit(a, b, n_iter=8))(jnp.asarray(X), jnp.asarray(y))
    coef, icpt = pr.logistic_fit(_t(X), _t(y), n_iter=8)
    npt.assert_allclose(coef.numpy(), np.asarray(want[0]), rtol=0, atol=ATOL)
    npt.assert_allclose(icpt.numpy(), np.asarray(want[1]), rtol=0, atol=ATOL)
    p = pr.logistic_predict_proba(coef, icpt, _t(X))
    wp = jax.vmap(jr.logistic_predict_proba)(want[0], want[1], jnp.asarray(X))
    npt.assert_allclose(p.numpy(), np.asarray(wp), rtol=0, atol=ATOL)


# ----------------------------------------------------------------------
# plain K7 / K8 against the Pallas kernels (interpret mode), float32
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KN.KINDS))
@pytest.mark.parametrize("thresh", [None, 13.0])
def test_plain_k7_matches_pallas_kernel(rng, kind, thresh):
    Xt, yt, Xq = _gard_data(rng, 3, 70, 23, 2, np.float32)
    k = 1 if kind == "best_analog" else 20
    rand = rng.integers(0, k, (3, 23)).astype(np.int32)
    want = pallas_pure_analog_stats(
        jnp.asarray(Xt), jnp.asarray(yt), jnp.asarray(Xq), jnp.asarray(rand),
        k=k, kind=kind, thresh=thresh, interpret=True,
    )
    got = KN.pure_analog_stats(_t(Xt), _t(yt), _t(Xq), _t(rand), k=k, kind=kind, thresh=thresh)
    assert got.dtype == torch.float32 and got.shape == (3, 23, 3)
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_plain_k7_tie_order_matches_pallas_kernel(rng):
    """Every training row duplicated and every query on a training point:
    exact distance ties, resolved toward the lower index in both."""
    C, n, m, f, k = 2, 48, 9, 2, 8
    base = rng.normal(0, 1, (C, n // 2, f)).astype(np.float32)
    Xt = np.concatenate([base, base], axis=1)
    yt = rng.normal(5, 2, (C, n)).astype(np.float32)
    Xq = base[:, :m, :] + 0.0
    rand = rng.integers(0, k, (C, m)).astype(np.int32)
    for kind in ("mean_analogs", "sample_analogs"):
        want = pallas_pure_analog_stats(
            jnp.asarray(Xt), jnp.asarray(yt), jnp.asarray(Xq), jnp.asarray(rand),
            k=k, kind=kind, thresh=None, interpret=True,
        )
        got = KN.pure_analog_stats(_t(Xt), _t(yt), _t(Xq), _t(rand), k=k, kind=kind)
        npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the selected set itself: lower indices first among the ties
    _, inds = KN._select(*KN._centre(_t(Xt), _t(Xq))[:2], k)
    assert (inds[..., 0] < n // 2).all() and (inds[..., 1] == inds[..., 0] + n // 2).all()


def test_plain_k7_all_below_threshold(rng):
    Xt, yt, Xq = _gard_data(rng, 1, 40, 5, 2, np.float32)
    rand = np.zeros((1, 5), np.int32)
    for kind in ("mean_analogs", "weight_analogs"):
        got = KN.pure_analog_stats(_t(Xt), _t(yt), _t(Xq), _t(rand), k=10, kind=kind, thresh=1e9).numpy()
        npt.assert_array_equal(got[..., 0], 0.0)
        npt.assert_array_equal(got[..., 1], 0.0)
        assert np.isnan(got[..., 2]).all()


@pytest.mark.parametrize("thresh", [None, 13.0])
@pytest.mark.parametrize("f", [1, 2, 3, 5])
def test_plain_k8_matches_pallas_kernel(rng, thresh, f):
    C, n, m, k = 2, 90, 17, 25
    Xt, yt, Xq = _gard_data(rng, C, n, m, f, np.float32)
    want = np.asarray(
        jg.analog_regression_predict_batched(
            jnp.asarray(Xt), jnp.asarray(yt), jnp.asarray(Xq), k=k, thresh=thresh,
            force_kernel=True, interpret=True,
        )
    )
    stats, prob, mu, ybar = KN.analog_regression_stats(_t(Xt), _t(yt), _t(Xq), k=k, thresh=thresh)
    assert stats.shape == (C, m, KN.n_stat_rows(f)) and prob.shape == (C, m)
    got = pg._ar_finish(stats, prob, mu, ybar, _t(Xq), f).numpy()
    npt.assert_allclose(got[..., 0], want[..., 0], rtol=2e-4, atol=2e-4)  # pred
    npt.assert_allclose(got[..., 1], want[..., 1], rtol=5e-4, atol=5e-4)  # prob
    npt.assert_allclose(got[..., 2], want[..., 2], rtol=2e-3, atol=2e-3)  # rmse


def test_plain_k8_none_exceed(rng):
    C, n, m, f, k = 1, 60, 5, 2, 10
    Xt = rng.normal(10, 3, (C, n, f)).astype(np.float32)
    yt = rng.normal(5, 1, (C, n)).astype(np.float32)
    Xq = rng.normal(10, 3, (C, m, f)).astype(np.float32)
    want = np.asarray(
        jg.analog_regression_predict_batched(
            jnp.asarray(Xt), jnp.asarray(yt), jnp.asarray(Xq), k=k, thresh=1e9,
            force_kernel=True, interpret=True,
        )
    )
    got = pg.analog_regression_predict_batched(_t(Xt), _t(yt), _t(Xq), k=k, thresh=1e9).numpy()
    # no exceeding analogs: prob 0, pred and error NaN (the reference crashes)
    npt.assert_array_equal(got[..., 1], 0.0)
    assert np.isnan(got[..., 0]).all() and np.isnan(got[..., 2]).all()
    npt.assert_array_equal(np.isnan(got), np.isnan(want))


def test_k8_newton_matches_jax_logistic_fit_on_the_selected_analogs(rng):
    """The plain K8 Newton (centred x, cofactor / Cholesky steps) against
    the JAX package's logistic_fit on the same selected analogs (raw x),
    float64: Newton's method is affine invariant and the ridge is on the
    coefficients only."""
    for f in (2, 5):
        Xt, yt, Xq = _gard_data(rng, 2, 80, 11, f)
        inds = np.asarray(jax.vmap(lambda a, b: jax_knn(a, b, 30, return_distance=False))(
            jnp.asarray(Xt), jnp.asarray(Xq)))
        xk = np.take_along_axis(Xt[:, None], inds[..., None], axis=2)  # (C, m, k, f)
        ex = (np.take_along_axis(yt[:, None], inds, axis=2) > 15.0).astype(float)
        lc, li = jax.vmap(jax.vmap(lambda a, b: jr.logistic_fit(a, b, n_iter=8)))(jnp.asarray(xk), jnp.asarray(ex))
        p0 = 1.0 - np.asarray(jax.nn.sigmoid(jnp.sum(jnp.asarray(Xq) * lc, -1) + li))
        n_ex = ex.sum(-1)
        want = np.where(n_ex >= 30, 1.0, np.where(n_ex <= 0, 0.0, p0))
        _, prob, _, _ = KN.analog_regression_stats(_t(Xt), _t(yt), _t(Xq), k=30, thresh=15.0)
        npt.assert_allclose(prob.numpy(), want, rtol=0, atol=ATOL)
