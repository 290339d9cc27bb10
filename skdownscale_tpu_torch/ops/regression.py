"""Closed-form simple regression over the last axis.

Port of ``ols_1d`` in ``skdownscale_tpu/ops/regression.py``: the reference
fits one scikit-learn ``LinearRegression`` per group tail; here every
(cell, group) problem is one row of a batched closed form.
"""

from __future__ import annotations

import torch

__all__ = ["ols_1d"]


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
