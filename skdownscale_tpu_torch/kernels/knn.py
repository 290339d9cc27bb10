"""Fused GARD analog kernels (K7, K8): wrappers, plain PyTorch versions and
launch counts.

:func:`pure_analog_stats` (K7) gives PureAnalog's ``[pred,
exceedance_prob, prediction_error]`` per query, and
:func:`analog_regression_stats` (K8) AnalogRegression's weighted-OLS
sufficient statistics and logistic exceedance probability per query, both
from the exact k nearest training rows of the query's cell in ascending
(squared distance, training index) order, the order of ``lax.top_k`` (the
lower index wins a tie).  They replace ``pure_analog_stats`` and
``analog_regression_stats`` of ``skdownscale_tpu/ops/pallas/knn_kernel.py``.

Distances are taken from features centred on each cell's training mean, by
the direct form ``sum_j (q_j - t_j)^2`` in feature order
(:func:`~..ops.knn.sq_dist_direct`); the plain versions and the CUDA kernels
of ``csrc/knn.cu`` evaluate it without fused multiply-adds, so on the card
both select the same analogs.  The plain versions are the gather route:
distances, a stable sort, a gather of the selected analogs, reductions; they
work on blocks of cells so that a (cells, queries, train) block stays near
:data:`PLAIN_BLOCK_ELEMS` elements.

The kernels stage a cell's training rows in shared memory once per block
and select a query's analogs in two passes over them: an 11-bit first digit
of each distance counted as it is computed, then one compaction that takes
the rows of lower bins outright and ranks the few rows of the k-th bin on a
short candidate list; further digit passes run only where that bin
overflows the list (``csrc/knn.cu``, modelled in
``tests/test_torch_knn_select.py``).  :func:`launch_geometry` reports the
shape a launch takes.

Dispatch: tensors on the CPU go to the plain version; CUDA float32 tensors
launch the kernel, which takes 1 <= f <= 6 features (K7) or 1 <= f <= 5
(K8) and k <= 4096, and raises on anything else; other tensors raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.gather import take_rows
from ..ops.knn import select_smallest, sq_dist_direct
from . import LAUNCHES, build, check_launch, on_kernel

__all__ = [
    "LAUNCHES",
    "KINDS",
    "MAX_K",
    "MAX_FEATURES_PURE",
    "MAX_FEATURES_REGRESSION",
    "n_stat_rows",
    "analog_outputs",
    "pure_analog_stats",
    "pure_analog_stats_plain",
    "analog_regression_stats",
    "analog_regression_stats_plain",
    "launch_geometry",
]

KINDS = ("best_analog", "sample_analogs", "weight_analogs", "mean_analogs")
MAX_K = 4096
MAX_FEATURES_PURE = 6
MAX_FEATURES_REGRESSION = 5
# elements of one plain (cells, queries, train) distance block
PLAIN_BLOCK_ELEMS = 1 << 26


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use only), load and declare ``csrc/knn.cu``."""
    lib = build.load("knn")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sdt_pure_analog_stats.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, f32, vp]
    lib.sdt_pure_analog_stats.restype = i32
    lib.sdt_analog_regression_stats.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, f32, i32, vp]
    lib.sdt_analog_regression_stats.restype = i32
    lib.sdt_knn_geometry.argtypes = [i32, i32, i32, i32, i32, i32, vp]
    lib.sdt_knn_geometry.restype = i32
    lib.sdt_error_string.argtypes = [i32]
    lib.sdt_error_string.restype = ctypes.c_char_p
    return lib


GEOMETRY_KEYS = ("staged", "warps", "tiles", "blocks_per_sm", "smem_bytes", "resident_warps",
                 "first_bits", "cap")


def launch_geometry(kernel: str, C: int, n: int, m: int, f: int, k: int) -> dict:
    """The launch K7 (``"pure_analog_stats"``) or K8
    (``"analog_regression_stats"``) takes at these sizes on the current
    card, launching nothing: whether the cell is staged in shared memory,
    warps a block, query tiles a cell, blocks and resident warps an SM,
    shared bytes a block, the first digit's bits and the candidate list's
    capacity.  Needs the card."""
    lib = _lib()
    res = (ctypes.c_int * len(GEOMETRY_KEYS))()
    which = ("pure_analog_stats", "analog_regression_stats").index(kernel)
    check_launch(lib, lib.sdt_knn_geometry(which, C, n, m, f, k, ctypes.addressof(res)), kernel)
    return dict(zip(GEOMETRY_KEYS, res))


def n_stat_rows(f: int) -> int:
    """Statistic rows of K8: sum w, sum w x (f), sum w x x^T (upper
    triangle), sum w yc, sum w x yc (f), sum w yc^2."""
    return 1 + f + f * (f + 1) // 2 + 1 + f + 1


def _check(X, y, Xq, k: int):
    """(C, n, f, m) after checking shapes and ``1 <= k <= n``."""
    if X.dim() != 3 or y.dim() != 2 or Xq.dim() != 3:
        raise ValueError(
            f"expected X (C, n, f), y (C, n), Xq (C, m, f), got {tuple(X.shape)}, "
            f"{tuple(y.shape)}, {tuple(Xq.shape)}"
        )
    C, n, f = X.shape
    if tuple(y.shape) != (C, n) or Xq.shape[0] != C or Xq.shape[2] != f:
        raise ValueError(f"shapes do not agree: X {tuple(X.shape)}, y {tuple(y.shape)}, Xq {tuple(Xq.shape)}")
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, n={n}], got {k}")
    return C, n, f, Xq.shape[1]


def _centre(X, Xq):
    """Features centred on each cell's training mean (the same tensors for
    the kernel and its plain version) and the mean (C, 1, f)."""
    mu = X.mean(dim=1, keepdim=True)
    return (X - mu).contiguous(), (Xq - mu).contiguous(), mu


def _blocks(C: int, m: int, n: int):
    step = max(1, PLAIN_BLOCK_ELEMS // max(m * n, 1))
    return [(c0, min(C, c0 + step)) for c0 in range(0, C, step)]


def _select(Xc, Xqc, k: int):
    """(squared distances, training indices) of the k nearest rows, each
    (Cb, m, k), ascending with the lower index first on a tie."""
    return select_smallest(sq_dist_direct(Xc, Xqc), k)


def _rows(a, inds):
    """Rows of a (Cb, n, p) by inds (Cb, m, k) -> (Cb, m, k, p)."""
    return take_rows(a, inds.flatten(-2)).reshape(*inds.shape, a.shape[-1])


def analog_outputs(analogs, dist, rand, kind: str, thresh=None):
    """PureAnalog's ``[pred, exceedance_prob, prediction_error]`` (..., 3)
    from the selected analogs' targets ``analogs`` and distances ``dist``
    (..., k), ascending; ``rand`` (...) the ranks - 1 for sample analogs
    (``gard.py:81-109``).

    With ``thresh``: NaN ``prediction_error`` if any analog is at or below
    it, and then ``pred`` 0 for the mean and weighted kinds (``nan_to_num``);
    ``exceedance_prob`` is the count above it over k."""
    k = analogs.shape[-1]
    if thresh is not None:
        mask = analogs > thresh
        masked = torch.where(mask, analogs, float("nan"))
    src = masked if thresh is not None else analogs
    if kind == "best_analog":
        pred = analogs[..., 0]
    elif kind == "sample_analogs":
        # the JAX gather clamps an index outside [0, k)
        pred = torch.gather(analogs, -1, rand.long().clamp(0, k - 1)[..., None])[..., 0]
    elif kind == "weight_analogs":
        # np.average: NaN analogs poison the sum (gard.py:325-327)
        weights = 1.0 / torch.where(dist == 0, 1e-20, dist)
        pred = (src * weights).sum(dim=-1) / weights.sum(dim=-1)
    elif kind == "mean_analogs":
        pred = src.mean(dim=-1)  # plain mean: NaNs propagate
    else:
        raise ValueError(f"got unexpected kind {kind}")
    if thresh is not None:
        pred = torch.nan_to_num(pred, nan=0.0)
        err = masked.std(dim=-1, correction=0)  # NaNs kept (gard.py:342)
        # a division by a tensor, correctly rounded as the kernel's (PyTorch
        # divides a CUDA tensor by a Python number as a product with its
        # reciprocal, which can differ in the last place)
        count = mask.sum(dim=-1).to(analogs.dtype)
        prob = count / torch.full_like(count, k)
    else:
        err = analogs.std(dim=-1, correction=0)
        prob = torch.ones_like(pred)
    return torch.stack([pred, prob, err], dim=-1)


def pure_analog_stats_plain(X, y, Xq, rand, *, k: int, kind: str, thresh=None):
    """Plain PyTorch version of K7, any float dtype and device:
    (C, n, f), (C, n), (C, m, f), rand (C, m) -> (C, m, 3)."""
    C, n, f, m = _check(X, y, Xq, k)
    Xc, Xqc, _ = _centre(X, Xq)
    outs = []
    for c0, c1 in _blocks(C, m, n):
        d2, inds = _select(Xc[c0:c1], Xqc[c0:c1], k)
        analogs = _rows(y[c0:c1, :, None], inds)[..., 0]
        outs.append(analog_outputs(analogs, torch.sqrt(d2), rand[c0:c1], kind, thresh))
    return torch.cat(outs) if outs else X.new_zeros((0, m, 3))


def pure_analog_stats(X, y, Xq, rand, *, k: int, kind: str, thresh=None):
    """K7: fused PureAnalog predict, (C, n, f), (C, n), (C, m, f), rand
    (C, m) int32 -> (C, m, 3): by the CUDA kernel for CUDA float32 tensors,
    by the plain version for CPU tensors."""
    C, n, f, m = _check(X, y, Xq, k)
    if kind not in KINDS:
        raise ValueError(f"got unexpected kind {kind}")
    if not on_kernel(X, y, Xq):
        return pure_analog_stats_plain(X, y, Xq, rand, k=k, kind=kind, thresh=thresh)
    if f > MAX_FEATURES_PURE or k > MAX_K:
        raise ValueError(f"the K7 kernel takes f <= {MAX_FEATURES_PURE} and k <= {MAX_K}, got f={f}, k={k}")
    if rand.dtype != torch.int32 or rand.device != X.device or tuple(rand.shape) != (C, m):
        raise TypeError(f"rand must be int32 ({C}, {m}) on {X.device}, got {rand.dtype} {tuple(rand.shape)} on {rand.device}")
    rand = rand.contiguous()
    out = torch.empty((C, m, 3), dtype=X.dtype, device=X.device)
    if C == 0 or m == 0:
        return out
    Xc, Xqc, _ = _centre(X, Xq)
    lib = _lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.sdt_pure_analog_stats(
            Xc.data_ptr(), y.data_ptr(), Xqc.data_ptr(), rand.data_ptr(), out.data_ptr(),
            C, n, m, f, k, KINDS.index(kind), thresh is not None,
            0.0 if thresh is None else float(thresh), stream,
        )
    check_launch(lib, rc, "pure_analog_stats")
    LAUNCHES["pure_analog_stats"] += 1
    return out


def _solve_newton(H, g):
    """Solve the symmetric (f+1)x(f+1) Newton system ``H d = g`` given as a
    list of lists of tensors: cofactors for 2x2 and 3x3, an unrolled
    Cholesky above (the kernel's formulas, one elementwise op at a time)."""
    P = len(g)
    if P == 2:
        det = H[0][0] * H[1][1] - H[0][1] * H[0][1]
        return [(H[1][1] * g[0] - H[0][1] * g[1]) / det, (H[0][0] * g[1] - H[0][1] * g[0]) / det]
    if P == 3:
        h00, h01, h02, h11, h12, h22 = H[0][0], H[0][1], H[0][2], H[1][1], H[1][2], H[2][2]
        A = h11 * h22 - h12 * h12
        B = -(h01 * h22 - h12 * h02)
        Cc = h01 * h12 - h11 * h02
        det = h00 * A + h01 * B + h02 * Cc
        i01, i02 = -(h01 * h22 - h02 * h12), h01 * h12 - h02 * h11
        i11, i12 = h00 * h22 - h02 * h02, -(h00 * h12 - h02 * h01)
        i22 = h00 * h11 - h01 * h01
        return [
            (A * g[0] + i01 * g[1] + i02 * g[2]) / det,
            (i01 * g[0] + i11 * g[1] + i12 * g[2]) / det,
            (i02 * g[0] + i12 * g[1] + i22 * g[2]) / det,
        ]
    L = [[None] * P for _ in range(P)]
    for i in range(P):
        for j in range(i + 1):
            s = H[j][i]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    z = [None] * P
    for i in range(P):
        s = g[i]
        for p in range(i):
            s = s - L[i][p] * z[p]
        z[i] = s / L[i][i]
    d = [None] * P
    for i in reversed(range(P)):
        s = z[i]
        for p in range(i + 1, P):
            s = s - L[p][i] * d[p]
        d[i] = s / L[i][i]
    return d


def _logistic_prob(xk, t, qc, n_iter: int):
    """The kernel's exceedance probability: ``n_iter`` ridge-damped Newton
    steps from 0 on the selected analogs' centred features ``xk``
    (..., k, f) and exceedance ``t`` (..., k), then ``1 - sigmoid`` at the
    centred query ``qc`` (..., f); 1 where every analog exceeds, 0 where
    none does."""
    f, k = xk.shape[-1], xk.shape[-2]
    eps = torch.finfo(xk.dtype).eps * 10
    x = [xk[..., a] for a in range(f)] + [torch.ones_like(t)]
    beta = [t.new_zeros(t.shape[:-1]) for _ in range(f + 1)]
    for _ in range(n_iter):
        z = sum(x[a] * beta[a][..., None] for a in range(f))
        p = torch.sigmoid(z + beta[f][..., None])
        r = p - t
        h = p * (1.0 - p)
        g = [(r * x[a]).sum(dim=-1) + (beta[a] if a < f else 0.0) for a in range(f + 1)]
        H = [[None] * (f + 1) for _ in range(f + 1)]
        for a in range(f + 1):
            for b in range(a, f + 1):
                s = (h * x[a] * x[b]).sum(dim=-1)
                if a == b:
                    # ridge: +1 (C = 1 L2 penalty) on the coefficients, +10 eps everywhere
                    s = s + (1.0 + eps if a < f else eps)
                H[a][b] = H[b][a] = s
        d = _solve_newton(H, g)
        beta = [beta[a] - d[a] for a in range(f + 1)]
    zq = sum(qc[..., a] * beta[a] for a in range(f))
    p0 = 1.0 - torch.sigmoid(zq + beta[f])  # predict_proba[:, 0] (gard.py:210)
    n_ex = t.sum(dim=-1)
    prob = torch.where(n_ex >= k, 1.0, p0)
    return torch.where(n_ex <= 0, 0.0, prob)


def _regression_block(xk, yk, yck, qc, thresh, n_iter: int):
    """K8's (..., R + 1) rows from the gathered analogs."""
    f = xk.shape[-1]
    t = (yk > thresh).to(yk.dtype) if thresh is not None else torch.ones_like(yk)
    x = [xk[..., a] for a in range(f)]
    rows = [t.sum(dim=-1)]
    rows += [(t * x[a]).sum(dim=-1) for a in range(f)]
    rows += [(t * x[a] * x[b]).sum(dim=-1) for a in range(f) for b in range(a, f)]
    rows.append((t * yck).sum(dim=-1))
    rows += [(t * x[a] * yck).sum(dim=-1) for a in range(f)]
    rows.append((t * yck * yck).sum(dim=-1))
    if thresh is not None:
        rows.append(_logistic_prob(xk, t, qc, n_iter))
    else:
        rows.append(torch.ones_like(rows[0]))
    return torch.stack(rows, dim=-1)


def analog_regression_stats_plain(X, y, Xq, *, k: int, thresh=None, n_iter: int = 8):
    """Plain PyTorch version of K8, any float dtype and device; returns what
    :func:`analog_regression_stats` returns."""
    C, n, f, m = _check(X, y, Xq, k)
    Xc, Xqc, mu = _centre(X, Xq)
    ybar = y.mean(dim=1, keepdim=True)
    yc = y - ybar
    outs = []
    for c0, c1 in _blocks(C, m, n):
        _, inds = _select(Xc[c0:c1], Xqc[c0:c1], k)
        outs.append(
            _regression_block(
                _rows(Xc[c0:c1], inds), *_rows(torch.stack([y, yc], dim=-1)[c0:c1], inds).unbind(-1),
                Xqc[c0:c1], thresh, n_iter,
            )
        )
    R = n_stat_rows(f)
    out = torch.cat(outs) if outs else X.new_zeros((0, m, R + 1))
    return out[..., :R], out[..., R], mu, ybar


def analog_regression_stats(X, y, Xq, *, k: int, thresh=None, n_iter: int = 8):
    """K8: fused AnalogRegression front half, (C, n, f), (C, n), (C, m, f)
    -> ``(stats (C, m, R), prob (C, m), mu (C, 1, f), ybar (C, 1))``: the
    weighted-OLS sums over centred x (per-cell training mean ``mu``) and y
    (per-cell mean ``ybar``) in the row order of :func:`n_stat_rows`, and
    the logistic exceedance probability.  By the CUDA kernel for CUDA
    float32 tensors, by the plain version for CPU tensors."""
    C, n, f, m = _check(X, y, Xq, k)
    if not on_kernel(X, y, Xq):
        return analog_regression_stats_plain(X, y, Xq, k=k, thresh=thresh, n_iter=n_iter)
    if f > MAX_FEATURES_REGRESSION or k > MAX_K:
        raise ValueError(
            f"the K8 kernel takes f <= {MAX_FEATURES_REGRESSION} and k <= {MAX_K}, got f={f}, k={k}"
        )
    R = n_stat_rows(f)
    out = torch.empty((C, m, R + 1), dtype=X.dtype, device=X.device)
    Xc, Xqc, mu = _centre(X, Xq)
    ybar = y.mean(dim=1, keepdim=True)
    if C > 0 and m > 0:
        lib = _lib()
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream(X.device).cuda_stream
            rc = lib.sdt_analog_regression_stats(
                Xc.data_ptr(), y.data_ptr(), ybar.data_ptr(), Xqc.data_ptr(), out.data_ptr(),
                C, n, m, f, k, thresh is not None, 0.0 if thresh is None else float(thresh),
                n_iter, stream,
            )
        check_launch(lib, rc, "analog_regression_stats")
        LAUNCHES["analog_regression_stats"] += 1
    return out[..., :R], out[..., R], mu, ybar
