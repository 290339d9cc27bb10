"""Brute-force batched k-nearest-neighbour search.

Port of ``skdownscale_tpu/ops/knn.py``.  The reference builds a
``sklearn.neighbors.KDTree`` per grid cell and queries it per time step
(``pointwise_models/gard.py:82,194,299``); brute force over a cell's
training record batches over cells and queries instead.

Results are sorted ascending by distance, matching ``KDTree.query``; ties
are broken toward the lower training index (``lax.top_k``'s stable order in
the JAX package).  The GARD grid path does not come here on the card: it
runs the fused kernels of :mod:`..kernels.knn`.
"""

from __future__ import annotations

import torch

__all__ = ["knn", "sq_dist_direct", "select_smallest"]


def sq_dist_direct(train, queries):
    """Squared distances (..., m, n) by the direct difference form
    ``sum_j (q_j - t_j)^2``, summed in feature order, one elementwise
    operation at a time (so no fused multiply-add forms: the CUDA kernels of
    :mod:`..kernels.knn` evaluate the same expression with ``__f*_rn``
    intrinsics and get the same bits)."""
    d2 = None
    for j in range(train.shape[-1]):
        diff = queries[..., :, None, j] - train[..., None, :, j]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def select_smallest(d2, k: int):
    """The k smallest entries of the last axis in ascending (value, index)
    order -> (values, indices): a stable sort, so equal values keep the
    lower index first, as ``lax.top_k`` on ``-d2`` does."""
    vals, inds = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], inds[..., :k]


def _knn_block(train, tn, queries, k: int):
    f = train.shape[-1]
    if f <= 4:
        # direct difference form: the expanded |q|^2 - 2qt + |t|^2 suffers
        # catastrophic f32 cancellation for clustered climate values (~300 K),
        # flipping near-tie neighbor sets; for few features the broadcast
        # form is exact and the product wasn't the bottleneck anyway
        diff = queries[..., :, None, :] - train[..., None, :, :]  # (..., m, n, f)
        d2 = (diff * diff).sum(dim=-1)
    else:
        # |q - t|^2 = |q|^2 - 2 q.t + |t|^2 in full precision (TF32 is off in
        # this package: the JAX package ran the cross term at HIGHEST)
        qn = (queries * queries).sum(dim=-1, keepdim=True)  # (..., m, 1)
        cross = queries @ train.transpose(-1, -2)  # (..., m, n)
        d2 = qn - 2.0 * cross + tn[..., None, :]
    d2 = torch.clamp(d2, min=0.0)
    neg, inds = select_smallest(d2, k)
    return torch.sqrt(neg), inds


def knn(train, queries, k: int, *, return_distance: bool = True, query_chunk: int = 64, approx: bool = False):
    """k nearest neighbours by Euclidean distance.

    Parameters
    ----------
    train : (..., n, f) training points
    queries : (..., m, f) query points
    k : neighbour count
    query_chunk : process queries in chunks of this size, bounding the
        (..., chunk, n) distance block.  ``None`` disables chunking.
    approx : accepted for API parity.  The JAX package's ``approx_max_k``
        is approximate only on a TPU and falls back to an exact top-k
        elsewhere; this port always selects exactly.

    Returns
    -------
    (dist, inds) : ((..., m, k), (..., m, k)) ascending by distance, or
    just inds if ``return_distance=False``.
    """
    # center on the training mean: distances are translation-invariant, and
    # centering shrinks |t|^2/|q|^2 to the data's spread so the expanded
    # form's cancellation error sits far below near-tie gaps
    mu = train.mean(dim=-2, keepdim=True)
    train = train - mu
    queries = queries - mu
    tn = (train * train).sum(dim=-1)  # (..., n)
    m = queries.shape[-2]
    if query_chunk is None or m <= query_chunk:
        dist, inds = _knn_block(train, tn, queries, k)
    else:
        blocks = [
            _knn_block(train, tn, queries[..., q0 : q0 + query_chunk, :], k)
            for q0 in range(0, m, query_chunk)
        ]
        dist = torch.cat([b[0] for b in blocks], dim=-2)
        inds = torch.cat([b[1] for b in blocks], dim=-2)
    if not return_distance:
        return inds
    return dist, inds
