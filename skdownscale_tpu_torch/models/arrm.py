"""ARRM piecewise-linear regression.

Port of ``skdownscale_tpu/models/arrm.py``, re-designing the reference's
``PiecewiseLinearRegression`` (``pointwise_models/arrm.py``, which wraps
the optional ``pwlf`` package):

* :func:`arrm_breakpoints` ports the reference's windowed-r² breakpoint
  search (``arrm.py:19-105``): sliding trailing-window correlations over
  the sorted marginals, global-minimum picking with ±10-point exclusion
  zones, upper then lower half.  The window positions and banker's-rounded
  midpoints depend only on ``n`` and are host numpy; the picks run over a
  leading batch of cells, ``half`` steps each.
* Continuous piecewise-linear fits use the hinge basis
  ``y ~ b0 + b1·x + Σ_k c_k·max(0, x - t_k)``, solved by the normal
  equations with a ``1e-10·I`` ridge.
* ``fit_option='auto'`` refines quantile-spaced breakpoints by 200 Adam
  steps on the sum of squared residuals through the solve (its gradient by
  ``torch.autograd``); ``'fast'`` is one solve at quantile-spaced breaks.

The fits run in float64 on every device, and predictions evaluate the
fitted state in float64 before rounding to the input's dtype.  In float32
the trailing-window r² of the sorted marginals is rounding noise (a window
of ~50 nearly equal sorted values has a variance some 1e-4 of its mean
square, and r² sits within 1e-4 of 1), so the argmin picks other windows,
and the normal equations square the hinge design's condition number, so
float32 fits of close breaks lose most of their digits.  The JAX package
runs them in its input dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.rolling import _window_sum
from .base import SingleCellEstimator, asarray_2d

__all__ = [
    "PiecewiseLinearRegression",
    "arrm_breakpoints",
    "piecewise_fit",
    "piecewise_predict",
    "ArrmState",
    "arrm_fit_batched",
    "arrm_predict_batched",
]

_MIN_WIDTH = 10  # arrm.py:37


def _bankers(v: float) -> int:
    """Python round() half-to-even, applied to window midpoints (arrm.py:66)."""
    return int(round(v))


def _trailing_corr2(x, y, width: int):
    """r² of the trailing ``width`` window ending at each index of the last
    axis."""
    w = float(width)
    sx = _window_sum(x, width, center=False)
    sy = _window_sum(y, width, center=False)
    sxx = _window_sum(x * x, width, center=False)
    syy = _window_sum(y * y, width, center=False)
    sxy = _window_sum(x * y, width, center=False)
    cov = w * sxy - sx * sy
    vx = w * sxx - sx * sx
    vy = w * syy - sy * sy
    return (cov * cov) / (vx * vy)


def _mask_around(r2, center, half: int):
    """``r2[c, center[c]-half : center[c]+half+1] = 1`` (``arrm.py:77,101``)
    with exact Python-slice semantics: when ``center < half`` the negative
    start wraps and the assignment is empty, so nothing is masked (a
    reference quirk that matters in the lower-half pass, where small indices
    win)."""
    pos = torch.arange(r2.shape[-1], device=r2.device)
    c = center[:, None]
    in_zone = ((pos - c).abs() <= half) & (c >= half)
    return torch.where(in_zone, 1.0, r2)


@functools.lru_cache(maxsize=32)
def _geometry(n: int, window_width: float):
    """Host tables of the breakpoint search that depend only on ``n``: the
    phase-1 start, the window width, the phase-1 (midpoint, right end)
    pairs and the phase-2 (left end, midpoint, r² position) triples."""
    quantiles = (np.arange(1, n + 1) - 0.4) / (n + 0.2)
    start = int(np.argmin(np.abs(quantiles - 0.4)))  # arrm.py:55
    width = max(_bankers(window_width * n), _MIN_WIDTH)  # arrm.py:58
    # phase 1: windows [right-width, right) for right in [start, n]
    # (arrm.py:63-67).  Odd widths make banker's-rounded midpoints collide;
    # the reference's ascending loop means the LARGER right wins
    rights = np.arange(start, n + 1)
    mids1 = np.array([_bankers((2 * r - width) / 2) for r in rights])
    _, rev_first = np.unique(mids1[::-1], return_index=True)
    keep1 = len(mids1) - 1 - rev_first  # last occurrence per unique mid
    # phase 2: trailing windows below the first breakpoint (arrm.py:79-91);
    # the descending loop means the SMALLER left wins on collisions
    lefts = np.arange(0, max(n - width + 1, 1))
    mids2_all = np.array([_bankers((2 * ll + width) / 2) for ll in lefts])
    _, keep2 = np.unique(mids2_all, return_index=True)  # first occurrence per mid
    lefts2 = lefts[keep2]
    return (start, width, mids1[keep1], rights[keep1] - 1, lefts2, mids2_all[keep2],
            np.minimum(lefts2 + width - 1, n - 1))


def _arrm_breakpoints_core(Xs, Ys, *, window_width: float, max_breakpoints: int):
    """Breakpoint values of each row of the sorted marginals ``Xs``, ``Ys``
    (C, n): (C, 2 * (max_breakpoints // 2)), ascending."""
    C, n = Xs.shape
    dev = Xs.device
    start, width, mids1, src1, lefts2, mids2, src2 = _geometry(n, window_width)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    corr2 = _trailing_corr2(Xs, Ys, width)
    r2 = torch.full((C, n), 2.0, dtype=Xs.dtype, device=dev)
    r2[:, idx(mids1)] = corr2[:, idx(src1)]

    half = max_breakpoints // 2
    bp1 = []
    for _ in range(half):
        mind = torch.argmin(r2, dim=1)  # the first minimum, as jnp.argmin
        r2 = _mask_around(r2, mind, _MIN_WIDTH)
        bp1.append(mind)

    # `min(breakpoints, default=start)` falls back to start only when empty
    start2 = torch.stack(bp1).amin(dim=0) if half > 0 else torch.full((C,), start, device=dev)
    start2 = start2 - (_MIN_WIDTH // 2 + 1)
    m2 = idx(mids2)
    apply2 = idx(lefts2)[None, :] <= start2[:, None]
    r2[:, m2] = torch.where(apply2, corr2[:, idx(src2)], r2[:, m2])

    below = torch.arange(n, device=dev)[None, :] < start2[:, None]
    bp2 = []
    for _ in range(half):
        mind = torch.argmin(torch.where(below, r2, float("inf")), dim=1)
        r2 = _mask_around(r2, mind, _MIN_WIDTH)
        bp2.append(mind)

    if half == 0:
        return Xs[:, :0]
    bps = torch.sort(torch.stack(bp1 + bp2, dim=1), dim=1).values
    return torch.gather(Xs, 1, bps)


def arrm_breakpoints(X, y, window_width: float, max_breakpoints: int, *, device="cuda"):
    """Port of ``arrm_breakpoints`` (``arrm.py:19-105``): breakpoint *values*
    from the sorted marginals of X and y, computed in float64 on ``device``."""
    Xa = asarray_2d(X)
    if Xa.shape[1] != 1:
        raise ValueError(f"X must have exactly 1 feature, got {Xa.shape[1]}")
    ya = np.asarray(y, dtype=float).ravel()
    if len(Xa) != len(ya):
        raise ValueError(f"X and y must have the same length, got {len(Xa)} and {len(ya)}")
    dev = torch.device(device)
    Xs = torch.sort(torch.tensor(Xa[:, 0], dtype=torch.float64, device=dev)).values
    Ys = torch.sort(torch.tensor(ya, dtype=torch.float64, device=dev)).values
    bp = _arrm_breakpoints_core(Xs[None], Ys[None], window_width=window_width,
                                max_breakpoints=max_breakpoints)
    return bp[0].cpu().numpy()


# ----------------------------------------------------------------------
# continuous piecewise-linear least squares (hinge basis), any leading dims
# ----------------------------------------------------------------------


def _hinge_design(x, breaks):
    """``[1, x, max(0, x - t_1), ...]`` (..., T, K+2).  ``torch.maximum``
    splits the gradient at a tie, as ``jnp.maximum`` does."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    hinge = torch.maximum(x[..., :, None] - breaks[..., None, :], zero)
    return torch.cat([torch.ones_like(x)[..., None], x[..., None], hinge], dim=-1)


def piecewise_fit(x, y, breaks):
    """Least-squares continuous piecewise-linear fit of ``y`` on ``x``
    (..., T) with interior ``breaks`` (..., K): the (..., K+2) coefficients."""
    A = _hinge_design(x, breaks)
    At = A.mT
    AtA = At @ A + 1e-10 * torch.eye(A.shape[-1], dtype=x.dtype, device=x.device)
    # a singular system (coincident breaks in float32) gives non-finite
    # coefficients, as jnp.linalg.solve does, rather than raising
    return torch.linalg.solve_ex(AtA, At @ y[..., None])[0][..., 0]


def piecewise_predict(beta, breaks, x):
    return (_hinge_design(x, breaks) @ beta[..., None])[..., 0]


def _optimize_breaks(x, y, *, n_interior: int, n_iter: int = 200):
    """Deterministic breakpoint refinement of each row of ``x``, ``y``
    (..., T) (the JAX package's replacement for pwlf's stochastic
    differential evolution): Adam on the SSR through the hinge-basis solve,
    from quantile-spaced breaks.  A non-finite gradient entry is taken as 0,
    and each step's breaks are sorted, then clipped to the data range."""
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    qs = torch.linspace(0.0, 1.0, n_interior + 2, dtype=x.dtype, device=x.device)[1:-1]
    span = hi - lo
    breaks = lo + qs * span
    lr = 0.02 * span
    m = torch.zeros_like(breaks)
    v = torch.zeros_like(breaks)
    for t in range(1, n_iter + 1):
        b = breaks.detach().requires_grad_(True)
        with torch.enable_grad():
            r = piecewise_predict(piecewise_fit(x, y, b), b, x) - y
            # each row's SSR depends on its own breaks only, so the gradient
            # of the sum is every row's own gradient
            (g,) = torch.autograd.grad((r * r).sum(), b)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - 0.9**t)
        vhat = v / (1 - 0.999**t)
        breaks = breaks - lr * mhat / (torch.sqrt(vhat) + 1e-8 * span)
        breaks = torch.clamp(torch.sort(breaks, dim=-1).values, lo, hi)
    return breaks


# ----------------------------------------------------------------------
# batched (cells-leading) cores
# ----------------------------------------------------------------------


class ArrmState(NamedTuple):
    """Fitted piecewise-linear state for a batch of cells.

    ``breaks``: (C, K) interior breakpoints; ``beta``: (C, K+2) hinge-basis
    coefficients ``[b0, b1, c_1..c_K]``; ``x_min``/``x_max``: (C,) data range
    (the outer entries of pwlf-style ``fit_breaks_``, ref ``arrm.py:154``).
    """

    breaks: torch.Tensor  # float64, as every field
    beta: torch.Tensor
    x_min: torch.Tensor
    x_max: torch.Tensor

    float64_on_every_device = True  # a checkpoint keeps it so on any device


def _fast_breaks(x_min, x_max, k: int):
    qs = torch.as_tensor(np.linspace(0.0, 1.0, k + 2)[1:-1], dtype=x_min.dtype, device=x_min.device)
    return x_min[..., None] + qs * (x_max - x_min)[..., None]


def arrm_fit_batched(x, y, *, fit_option: str, n_segments: int) -> ArrmState:
    """Batched :class:`PiecewiseLinearRegression` fit over ``(C, T)``
    tensors (ref ``arrm.py:144-167`` semantics), in float64: the breakpoint
    search's geometry depends only on T, so one pass serves every cell."""
    x, y = x.double(), y.double()
    k = max(n_segments - 1, 1)
    x_min = x.amin(dim=1)
    x_max = x.amax(dim=1)
    if fit_option == "arrm":
        interior = _arrm_breakpoints_core(torch.sort(x, dim=1).values, torch.sort(y, dim=1).values,
                                          window_width=0.05, max_breakpoints=n_segments)
    elif fit_option == "auto":
        interior = _optimize_breaks(x, y, n_interior=k)
    elif fit_option == "fast":
        interior = _fast_breaks(x_min, x_max, k)
    else:
        raise ValueError(f"unsupported fit_option '{fit_option}'")
    return ArrmState(interior, piecewise_fit(x, y, interior), x_min, x_max)


def arrm_predict_batched(state: ArrmState, x):
    """Batched hinge-basis predict: ``(C, T)`` queries through per-cell
    fits, evaluated in the state's float64 and returned in ``x``'s dtype."""
    xs = x.to(state.beta.dtype)
    b0 = state.beta[:, 0:1]
    b1 = state.beta[:, 1:2]
    c = state.beta[:, 2:]  # (C, K)
    hinge = torch.clamp_min(xs[:, :, None] - state.breaks[:, None, :], 0.0)  # (C, T, K)
    return (b0 + b1 * xs + torch.einsum("ctk,ck->ct", hinge, c)).to(x.dtype)


class PiecewiseLinearRegression(SingleCellEstimator):
    """API of ``arrm.py:108-177`` (no pwlf dependency); fits and predicts on
    the single-cell device (``models/base.py``).

    Parameters
    ----------
    n_segments : int
        Desired number of line segments.
    fit_option : {'auto', 'fast', 'arrm'}
        'auto': deterministic breakpoint optimization; 'fast':
        quantile-spaced breakpoints; 'arrm': the reference's ARRM
        windowed-r² breakpoint search.
    """

    _fit_attributes = ["model_", "fit_breaks_"]

    def __init__(self, n_segments: int = 7, fit_option: str = "auto", pwlf_kwargs=None):
        self.n_segments = n_segments
        self.fit_option = fit_option
        self.pwlf_kwargs = pwlf_kwargs

    def fit(self, X, y, **kwargs):
        Xa = asarray_2d(X)
        ya = asarray_2d(y)[:, 0]
        if Xa.shape[1] != 1:
            raise ValueError(f"X must have exactly 1 feature, got {Xa.shape[1]}")
        self._check_n_features(Xa, reset=True)
        x = self._f64(Xa[:, 0])
        yt = self._f64(ya)
        k = max(self.n_segments - 1, 1)
        if self.fit_option == "arrm":
            interior = self._f64(arrm_breakpoints(Xa, ya, 0.05, self.n_segments, device=x.device))
        elif self.fit_option == "auto":
            interior = _optimize_breaks(x, yt, n_interior=k)
        elif self.fit_option == "fast":
            interior = _fast_breaks(x.amin(), x.amax(), k)
        else:
            raise ValueError(f"unsupported fit_option '{self.fit_option}'")
        beta = piecewise_fit(x, yt, interior)
        self._breaks = interior.cpu().numpy()
        self._beta = beta.cpu().numpy()
        # pwlf-style break vector: [x_min, interior..., x_max] (arrm.py:154)
        self.fit_breaks_ = np.concatenate([[float(np.min(Xa))], self._breaks, [float(np.max(Xa))]])
        self.model_ = self  # duck-type of the fitted pwlf model handle
        self.X_ = Xa
        self.y_ = ya
        return self

    def predict(self, X):
        self._check_is_fitted()
        Xa = asarray_2d(X)
        self._check_n_features(Xa, reset=False)
        out = piecewise_predict(self._f64(self._beta), self._f64(self._breaks), self._f64(Xa[:, 0]))
        return out.cpu().numpy()

    def _f64(self, a) -> torch.Tensor:
        """A host array in float64 on the single-cell device (the fits run
        in float64 on every device, see the module's notes)."""
        return torch.tensor(np.asarray(a), dtype=torch.float64, device=self._cell_device())
