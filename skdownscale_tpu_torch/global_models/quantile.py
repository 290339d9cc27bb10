"""Pooled ("global") quantile mapping over all cells.

Port of ``skdownscale_tpu/global_models/quantile.py``: one quantile
correction estimated from every valid sample of a (cells, time) grid and
applied to every cell, for short per-cell records or a spatially coherent
correction.

Without a mesh (or on a mesh of one shard) the fit sorts the flattened
valid samples once and evaluates the Cunnane plotting-position ladder
(``Q`` positions) on them with one K6 call (one row of ``cells x time``
knots, the ``Q`` positions as queries).  On a cell mesh it takes the JAX
package's stratified order-statistic sketch instead:

1. each shard sorts its cells' samples once and takes ``m`` equally spaced
   order statistics with weight ``n_local / m`` (an empty shard gives
   ``+inf`` samples of weight 0);
2. one ``all_gather`` moves the (shards, m) sketch, kilobytes and not the
   grid, to the first device in mesh order, and an ``all_reduce`` counts
   the samples;
3. the weighted merge (a stable payload sort, midpoint ranks) evaluates the
   ladder with one K6 call on the merged row of ``shards x m`` knots.

The sketch is deterministic, with a rank error of at most ``n_local/(2m)``
a shard.  It also takes grids whose exact ladder would need a K6 row above
its ``2**31 - 1`` knots.  Transforms map each cell row through the one
monotone table ``x_ladder -> y_ladder``, passed to K6 once as a table
shared by every row; on cell-sharded input each shard maps its rows on its
device, with no collective.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.interp import interp_rows
from ..parallel.mesh import ShardedCells, all_gather, all_reduce, as_mesh, map_shards, shard_cells
from ..utils.device import as_tensor

__all__ = [
    "GlobalQuantileState",
    "GlobalQuantileMapper",
    "ladder_positions",
    "pooled_quantile_table",
]

_ALPHA = 0.4  # Cunnane plotting positions, as everywhere in the package
_BETA = 0.4
# K6 takes a row of at most 2**31 - 1 knots (its length is a C int)
_K6_MAX_KNOTS = 2**31 - 1
# device bytes a pooled sample takes at the exact ladder's peak: the input
# and its finite mask, the sorted copy with its int64 sort positions, then
# the float64 plotting positions, their float32 copy and the two clamped
# knot rows
_LADDER_BYTES_PER_SAMPLE = 32


def ladder_positions(n_quantiles: int, dtype=torch.float64, device=None) -> torch.Tensor:
    i = torch.arange(n_quantiles, dtype=dtype, device=device)
    return (i + 1 - _ALPHA) / (n_quantiles + 1 - _ALPHA - _BETA)


class GlobalQuantileState(NamedTuple):
    pp: torch.Tensor  # (Q,) shared plotting positions
    x_ladder: torch.Tensor  # (Q,) pooled model quantiles
    y_ladder: torch.Tensor  # (Q,) pooled observed quantiles
    n_x: torch.Tensor  # () valid model samples
    n_y: torch.Tensor  # () valid observed samples


def _ladder_from_ranks(vals, mid, finite, W, pp):
    """The ladder at ``pp`` from samples ``vals`` sorted ascending, their
    midpoint ranks ``mid`` (float64, overwritten), which of them count
    (``finite``) and the total weight ``W``: Cunnane positions of the ranks,
    then one monotone interp onto ``pp``."""
    sp = mid.add_(0.5).sub_(_ALPHA).div_(W + 1 - _ALPHA - _BETA).to(vals.dtype)
    # zero-weight (+inf pad) samples sort last; clamp them onto the last
    # finite knot so the table stays monotone-finite
    v_last = torch.where(finite, vals, float("-inf")).amax()
    sp = torch.where(finite, sp, float("inf"))
    vals = torch.where(finite, vals, v_last)
    out = interp_rows(sp[None, :], vals[None, :], pp[None, :])[0]
    return torch.where(W > 0, out, float("nan"))


def _ladder_from_weighted(vals, w, pp):
    """The ladder from weighted samples: payload-sort by value,
    midpoint-rank plotting positions, monotone interp onto ``pp``.  Tied
    values keep their input order (the sort is stable), as ``lax.sort``
    orders them on the CPU: two shards' samples of one value carry
    different weights, and the tie's order moves its first and last
    midpoint ranks.

    The midpoint ranks are summed on the host in float64, in order: a
    CUDA cumsum (a single-pass scan) may associate its additions otherwise
    from run to run, and every process of a job must compute the same
    ladder.  The merged row is a sketch, kilobytes."""
    vals, order = torch.sort(vals, stable=True)
    w = w[order]
    wh = w.to("cpu", torch.float64)
    mid = (torch.cumsum(wh, dim=0) - 0.5 * wh).to(vals.device)
    finite = torch.isfinite(vals) & (w > 0)
    return _ladder_from_ranks(vals, mid, finite, wh.sum().to(vals.device), pp)


def _exact_ladder(vals, mask, pp):
    """Exact pooled ladder: one sort of the flattened valid values.  The
    weights are 1 on the valid prefix of the sorted values, so sample
    ``i``'s midpoint rank is ``i + 0.5``, taken from its integer position in
    float64 (a float32 cumsum of the weights is not exact past 2**24)."""
    N = vals.numel()
    if vals.is_cuda:
        if N > _K6_MAX_KNOTS:
            raise ValueError(
                f"the exact pooled ladder of {N} samples needs one K6 row of {N} knots, "
                f"above K6's {_K6_MAX_KNOTS}; pass a cell mesh (mesh=parallel.cell_mesh(...), "
                f"a mesh of repeated devices shares one card) to fit it by the sketch"
            )
        free, _ = torch.cuda.mem_get_info(vals.device)
        free += torch.cuda.memory_reserved(vals.device) - torch.cuda.memory_allocated(vals.device)
        need = N * _LADDER_BYTES_PER_SAMPLE
        if need > free:
            raise MemoryError(
                f"the exact pooled ladder of {N} samples needs about {need / 2**30:.2f} GiB "
                f"of device memory for its sort, and {free / 2**30:.2f} GiB are free"
            )
    flat = torch.where(mask, vals, float("inf")).reshape(-1)
    n = mask.sum()
    if flat.is_cuda:
        s = torch.sort(flat).values
    else:  # numpy's CPU sort is the faster of the two on large float arrays
        s = torch.from_numpy(np.sort(flat.numpy()))
    del flat
    # the valid samples are finite and sort first; the rest are the +inf fill
    mid = torch.arange(N, dtype=torch.float64, device=vals.device).add_(0.5)
    return _ladder_from_ranks(s, mid, torch.isfinite(s), n.to(torch.float64), pp), n


def _sketch_ladder(vals: ShardedCells, pp, m: int):
    """Per-shard sort + ``m``-point stratified sketch + an ``all_gather``
    merge (``skdownscale_tpu/global_models/quantile.py:96-113``).  The
    sample index ``(j + 0.5) * cnt / m`` is computed in the input's dtype,
    as the JAX version does."""
    mesh = vals.mesh

    def sketch(v):
        dtype = v.dtype
        mask = torch.isfinite(v)
        n_local = mask.sum()
        cnt = n_local.to(dtype)
        s = torch.sort(torch.where(mask, v, float("inf")).reshape(-1)).values
        j = torch.arange(m, dtype=dtype, device=v.device)
        r = torch.minimum(torch.clamp((j + 0.5) * cnt / m, min=0), torch.clamp(cnt - 1, min=0))
        empty = cnt == 0
        sample = torch.where(empty, float("inf"), s[r.to(torch.int64)])
        w = torch.where(empty, 0.0, (cnt / m).expand(m))
        return sample, w, n_local

    parts = map_shards(sketch, vals)
    all_s = all_gather([p[0] for p in parts], mesh).reshape(-1)
    all_w = all_gather([p[1] for p in parts], mesh).reshape(-1)
    n = all_reduce([p[2] for p in parts], mesh)
    return _ladder_from_weighted(all_s, all_w, pp.to(all_s.device)), n


def pooled_quantile_table(vals, pp, mesh=None, *, sample_per_shard: int = 8192):
    """Pooled quantile ladder of the finite entries of ``vals`` (C, T):
    (ladder (Q,), n_valid ()).

    ``mesh=None``, or a mesh of one shard: exact (one sort; a
    ``ShardedCells`` input is gathered to its first device).  On a cell
    mesh (``CellMesh`` or ``MeshSharding``) of several shards: the sketch
    above, exact to ``n_local / (2 * sample_per_shard)`` in rank, with only
    a kilobyte ``all_gather`` between devices; a tensor input is sharded
    over the mesh first.
    """
    mesh = None if mesh is None else as_mesh(mesh)
    if mesh is None or mesh.size == 1:
        if isinstance(vals, ShardedCells):
            vals = vals.gather(vals.mesh.devices[0])
        return _exact_ladder(vals, torch.isfinite(vals), pp)
    if not isinstance(vals, ShardedCells):
        vals, _ = shard_cells(vals, mesh)
    return _sketch_ladder(vals, pp, sample_per_shard)


class GlobalQuantileMapper:
    """Pooled quantile mapping: fit on (cells, time) model + observed grids,
    transform maps model values through the pooled correction.

    Parameters
    ----------
    n_quantiles : int | None
        Ladder size (default: min(2048, pooled sample count)).
    sample_per_shard : int
        Sketch size per shard on the sharded path.
    mesh : CellMesh | MeshSharding | None
        Cell mesh for the distributed (sketch) fit; None = exact fit.
    device : str or torch.device
        Where numpy inputs go: the card by default (float32), ``"cpu"`` for
        the input's dtype.  Tensors and ``ShardedCells`` stay where they
        are.  Without a card a CUDA device raises.

    ``transform`` maps X -> observed space (x_ladder -> y_ladder);
    ``inverse_transform`` maps back.  Tails clamp to the ladder ends, the
    convention of ``np.interp``.  Both return tensors on the inputs'
    device, or a ``ShardedCells`` for a ``ShardedCells``.
    """

    _fit_attributes = ["state_"]

    def __init__(self, n_quantiles: int | None = None, sample_per_shard: int = 8192, mesh=None,
                 device="cuda"):
        self.n_quantiles = n_quantiles
        self.sample_per_shard = sample_per_shard
        self.mesh = mesh
        self.device = device

    def _grid(self, a):
        if isinstance(a, ShardedCells):
            return a
        a = as_tensor(a, self.device, type(self).__name__)
        return a[None] if a.ndim == 1 else a

    def fit(self, X, y):
        X = self._grid(X)
        y = self._grid(y)
        if not isinstance(X, ShardedCells):
            y = y.to(X.device)
        dtype = torch.float64 if X.dtype == torch.float64 else torch.float32
        nq = self.n_quantiles
        if nq is None:
            nq = int(min(2048, np.prod(X.shape), np.prod(y.shape)))
        dev = X.mesh.devices[0] if isinstance(X, ShardedCells) else X.device
        pp = ladder_positions(nq, dtype, dev)
        x_ladder, n_x = pooled_quantile_table(_as(X, dtype), pp, self.mesh,
                                              sample_per_shard=self.sample_per_shard)
        y_ladder, n_y = pooled_quantile_table(_as(y, dtype), pp, self.mesh,
                                              sample_per_shard=self.sample_per_shard)
        self.state_ = GlobalQuantileState(pp, x_ladder, y_ladder, n_x, n_y)
        return self

    def _map(self, V, src, dst):
        # each cell row against the one shared ladder: K6 takes the table once
        V = self._grid(V)
        if isinstance(V, ShardedCells):
            return V.map(lambda v: self._map(v, src.to(v.device), dst.to(v.device)))
        V = V.to(src.dtype)
        out = interp_rows(src[None, :], dst[None, :], V)
        return torch.where(torch.isfinite(V), out, float("nan"))

    def transform(self, X):
        st = self.state_
        return self._map(X, st.x_ladder, st.y_ladder)

    def inverse_transform(self, y):
        st = self.state_
        return self._map(y, st.y_ladder, st.x_ladder)

    def get_params(self, deep: bool = True):
        return {
            "n_quantiles": self.n_quantiles,
            "sample_per_shard": self.sample_per_shard,
            "mesh": self.mesh,
            "device": self.device,
        }

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self


def _as(a, dtype):
    """A tensor or each shard of a ``ShardedCells`` in ``dtype``."""
    return a.map(lambda v: v.to(dtype)) if isinstance(a, ShardedCells) else a.to(dtype)
