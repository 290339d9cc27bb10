"""Batched closed-form regression.

Port of ``skdownscale_tpu/ops/regression.py``.  The reference fits one
scikit-learn ``LinearRegression`` / ``LogisticRegression`` at a time in
Python loops (``quantile.py:256-264``, ``gard.py:175,209-215``); here every
problem is one row of a batched closed form.  The JAX functions are written
for one problem and vmapped; these take any leading batch dimensions
instead (the vmap written out).  Weights of 0/1 subsume the reference's
boolean-mask row subsetting exactly (weighted least squares with 0/1 weights
is OLS on the selected rows).
"""

from __future__ import annotations

import torch

__all__ = [
    "ols_1d",
    "ols_predict_1d",
    "linreg_fit",
    "linreg_predict",
    "logistic_fit",
    "logistic_predict_proba",
    "rmse",
]


def ols_1d(x, y, w=None):
    """Simple least squares ``y ~ a + b*x`` over the LAST axis ->
    (slope, intercept) with the leading (batch) dims preserved.

    Matches ``sklearn.linear_model.LinearRegression`` on one feature
    (centered closed form).  ``w`` is an optional 0/1 (or general) weight
    array selecting/weighting samples.  Inputs broadcast against each other.
    """
    if w is None:
        x, y = torch.broadcast_tensors(x, y)
        xm = x.mean(dim=-1, keepdim=True)
        ym = y.mean(dim=-1, keepdim=True)
        dx = x - xm
        num = (dx * (y - ym)).sum(dim=-1)
        den = (dx * dx).sum(dim=-1)
    else:
        x, y, w = torch.broadcast_tensors(x, y, w)
        wsum = w.sum(dim=-1, keepdim=True)
        xm = (w * x).sum(dim=-1, keepdim=True) / wsum
        ym = (w * y).sum(dim=-1, keepdim=True) / wsum
        dx = x - xm
        num = (w * dx * (y - ym)).sum(dim=-1)
        den = (w * dx * dx).sum(dim=-1)
    xm = xm[..., 0]
    ym = ym[..., 0]
    # zero-variance design: sklearn's lstsq returns the min-norm solution
    # (coef 0, intercept = mean); the quantile tail re-extrapolation hits
    # this when cancellation collapses the pp knots to a constant
    nonzero = den != 0
    slope = torch.where(nonzero, num / torch.where(nonzero, den, torch.ones_like(den)), torch.zeros_like(num))
    intercept = ym - slope * xm
    return slope, intercept


def ols_predict_1d(slope, intercept, x):
    return intercept + slope * x


def linreg_fit(X, y, w=None):
    """Multi-feature least squares with intercept -> (coef (..., k),
    intercept (...)).

    ``X``: (..., n, k); ``y``: (..., n); ``w``: optional (..., n) weights
    (0/1 weights == row subsetting, as the reference does with boolean masks
    at ``gard.py:215`` / ``gard.py:441``).  Solves the centered normal
    equations with a pseudo-inverse, so rank-deficient analog sets
    (duplicate rows) yield the minimum-norm solution, matching sklearn's
    lstsq-based fit.
    """
    if w is None:
        xm = X.mean(dim=-2)
        ym = y.mean(dim=-1)
        Xc = X - xm[..., None, :]
        yc = y - ym[..., None]
    else:
        wsum = w.sum(dim=-1)
        xm = (w[..., None] * X).sum(dim=-2) / wsum[..., None]
        ym = (w * y).sum(dim=-1) / wsum
        sw = torch.sqrt(w)
        Xc = sw[..., None] * (X - xm[..., None, :])
        yc = sw * (y - ym[..., None])
    G = Xc.transpose(-1, -2) @ Xc
    b = (Xc.transpose(-1, -2) @ yc[..., None])[..., 0]
    coef = _psolve(G, b)
    intercept = ym - (coef * xm).sum(dim=-1)
    return coef, intercept


def _psolve(G, b):
    """Solve G x = b for symmetric PSD G (..., n, n) by an eigendecomposition
    pseudo-inverse (rank-deficient safe).

    For the 1x1 and 2x2 systems that dominate GARD (f <= 2) the
    eigendecomposition is analytic, with the same spectral cutoff as the
    ``eigh`` path, so rank-deficient behavior is identical to round-off;
    from 3x3 up it is ``torch.linalg.eigh``.
    """
    n = G.shape[-1]
    eps = torch.finfo(G.dtype).eps
    if n == 1:
        g = G[..., 0, 0]
        keep = g > eps * g.abs()  # g > 0 up to round-off, as the eigh path
        return torch.where(keep, b[..., 0] / torch.where(keep, g, 1.0), 0.0)[..., None]
    if n == 2:
        a, c, off = G[..., 0, 0], G[..., 1, 1], G[..., 0, 1]
        h = 0.5 * (a + c)
        d = 0.5 * (a - c)
        r = torch.sqrt(d * d + off * off)
        l1, l2 = h + r, h - r
        cutoff = eps * 2.0 * torch.maximum(l1.abs(), l2.abs())
        # eigenvector for l1 from whichever (G - l1 I) row is better
        # conditioned; the degenerate G = h*I case (both rows ~0) falls back
        # to (1, 0): any orthonormal basis gives the same pinv
        v1a = torch.stack([off, l1 - a], dim=-1)
        v1b = torch.stack([l1 - c, off], dim=-1)
        n1a = (v1a * v1a).sum(dim=-1)
        n1b = (v1b * v1b).sum(dim=-1)
        v1 = torch.where((n1a >= n1b)[..., None], v1a, v1b)
        norm = torch.sqrt(torch.clamp((v1 * v1).sum(dim=-1), min=0.0))[..., None]
        unit = torch.tensor([1.0, 0.0], dtype=G.dtype, device=G.device)
        v1 = torch.where(norm > 0, v1 / torch.where(norm > 0, norm, 1.0), unit)
        v2 = torch.stack([-v1[..., 1], v1[..., 0]], dim=-1)
        x = torch.zeros_like(b)
        for lam, v in ((l1, v1), (l2, v2)):
            keep = lam > cutoff
            coef = torch.where(keep, (v * b).sum(dim=-1) / torch.where(keep, lam, 1.0), 0.0)
            x = x + coef[..., None] * v
        return x
    evals, evecs = torch.linalg.eigh(G)
    cutoff = eps * n * evals.abs().amax(dim=-1, keepdim=True)
    keep = evals > cutoff
    inv = torch.where(keep, 1.0 / torch.where(keep, evals, 1.0), 0.0)
    return (evecs @ (inv * (evecs.transpose(-1, -2) @ b[..., None])[..., 0])[..., None])[..., 0]


def linreg_predict(coef, intercept, X):
    """``X @ coef + intercept`` for X (..., n, k), coef (..., k)."""
    return (X @ coef[..., None])[..., 0] + intercept[..., None]


def rmse(y_true, y_pred, w=None):
    """Root mean squared error over the last axis (optionally 0/1-weighted),
    matching ``sklearn.metrics.root_mean_squared_error`` (``gard.py:217-219``)."""
    if w is None:
        return torch.sqrt(((y_true - y_pred) ** 2).mean(dim=-1))
    return torch.sqrt((w * (y_true - y_pred) ** 2).sum(dim=-1) / w.sum(dim=-1))


# ----------------------------------------------------------------------
# logistic regression (sklearn-compatible objective)
# ----------------------------------------------------------------------


def _solve_small(H, g):
    """Solve H x = g for tiny static sizes by closed-form inverses (n <= 3),
    else ``torch.linalg.solve``; H (..., n, n), g (..., n)."""
    n = H.shape[-1]
    if n == 1:
        return g / H[..., 0, 0:1]
    if n == 2:
        a, b = H[..., 0, 0], H[..., 0, 1]
        c, d = H[..., 1, 0], H[..., 1, 1]
        det = a * d - b * c
        x0 = (d * g[..., 0] - b * g[..., 1]) / det
        x1 = (a * g[..., 1] - c * g[..., 0]) / det
        return torch.stack([x0, x1], dim=-1)
    if n == 3:
        a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
        d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
        g_, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
        A = e * i - f * h
        B = -(d * i - f * g_)
        Cc = d * h - e * g_
        det = a * A + b * B + c * Cc
        inv01, inv02 = -(b * i - c * h), b * f - c * e
        inv11, inv12 = a * i - c * g_, -(a * f - c * d)
        inv21, inv22 = -(a * h - b * g_), a * e - b * d
        g0, g1, g2 = g[..., 0], g[..., 1], g[..., 2]
        x0 = (A * g0 + inv01 * g1 + inv02 * g2) / det
        x1 = (B * g0 + inv11 * g1 + inv12 * g2) / det
        x2 = (Cc * g0 + inv21 * g1 + inv22 * g2) / det
        return torch.stack([x0, x1, x2], dim=-1)
    return torch.linalg.solve(H, g)


def logistic_fit(X, y, w=None, C: float = 1.0, n_iter: int = 12):
    """L2-regularized logistic regression -> (coef (..., k), intercept (...)).

    Minimizes sklearn's ``LogisticRegression`` objective (penalty='l2',
    intercept unpenalized)::

        0.5 * ||coef||^2 + C * sum_i w_i * log(1 + exp(-s_i * (X_i @ coef + b)))

    with ``s = 2y - 1``, by a fixed-iteration damped Newton (the problem is
    convex).  ``X``: (..., n, k); ``y``, ``w``: (..., n).
    """
    k = X.shape[-1]
    if w is None:
        w = torch.ones_like(y)
    Xb = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (..., n, k+1)
    reg = torch.cat([X.new_ones(k), X.new_zeros(1)])
    damp = torch.diag(reg) + torch.finfo(X.dtype).eps * 10 * torch.eye(k + 1, dtype=X.dtype, device=X.device)
    beta = X.new_zeros((*X.shape[:-2], k + 1))
    for _ in range(n_iter):
        p = torch.sigmoid((Xb @ beta[..., None])[..., 0])
        # gradient of C * logloss + 0.5 beta' R beta
        g = C * (Xb.transpose(-1, -2) @ (w * (p - y))[..., None])[..., 0] + reg * beta
        h_diag = C * w * p * (1.0 - p)
        # Levenberg damping keeps early steps stable when separable
        H = (Xb * h_diag[..., None]).transpose(-1, -2) @ Xb + damp
        beta = beta - _solve_small(H, g)
    return beta[..., :k], beta[..., k]


def logistic_predict_proba(coef, intercept, X):
    """Probability of class 1 (sklearn column ``[:, 1]``); X (..., n, k)."""
    return torch.sigmoid(linreg_predict(coef, intercept, X))
