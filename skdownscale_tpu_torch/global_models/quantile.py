"""Pooled ("global") quantile mapping over all cells.

Port of ``skdownscale_tpu/global_models/quantile.py`` on one device: one
quantile correction estimated from every valid sample of a (cells, time)
grid and applied to every cell, for short per-cell records or a spatially
coherent correction.

The fit sorts the flattened valid samples once and evaluates the Cunnane
plotting-position ladder (``Q`` positions) on them with one K6 call (one
row of ``cells x time`` knots, the ``Q`` positions as queries).  Transforms
map each cell row through the one monotone table ``x_ladder -> y_ladder``,
passed to K6 once as a table shared by every row.  The JAX package's
sharded path (a per-device sketch merged by ``all_gather``) waits for the
multi-device layer (ROADMAP Queue 1 A, "The multi-device layer"); a mesh
of more than one device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.interp import interp_rows
from ..parallel.mesh import MULTI_DEVICE_ITEM
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
    midpoint-rank plotting positions, monotone interp onto ``pp``."""
    vals, order = torch.sort(vals)
    w = w[order]
    mid = (torch.cumsum(w, dim=0) - 0.5 * w).to(torch.float64)
    finite = torch.isfinite(vals) & (w > 0)
    return _ladder_from_ranks(vals, mid, finite, w.sum().to(torch.float64), pp)


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
                f"above K6's {_K6_MAX_KNOTS}; the sketch path for such grids waits for "
                f"the multi-device layer ({MULTI_DEVICE_ITEM})"
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


def _mesh_devices(mesh) -> int:
    """Devices of a mesh: a ``torch.distributed`` DeviceMesh or a sequence."""
    size = getattr(mesh, "size", None)
    return int(size()) if callable(size) else len(mesh)


def pooled_quantile_table(vals, pp, mesh=None, *, sample_per_shard: int = 8192):
    """Pooled quantile ladder of the finite entries of ``vals`` (C, T):
    (ladder (Q,), n_valid ()).  ``mesh`` of one device (or None) is the
    exact one-device fit; more devices raise (``sample_per_shard`` is the
    sketch size of that path)."""
    if mesh is not None and _mesh_devices(mesh) > 1:
        raise NotImplementedError(
            f"the sharded pooled quantile sketch waits for the multi-device layer "
            f"({MULTI_DEVICE_ITEM}); pass mesh=None to fit on one device"
        )
    return _exact_ladder(vals, torch.isfinite(vals), pp)


class GlobalQuantileMapper:
    """Pooled quantile mapping: fit on (cells, time) model + observed grids,
    transform maps model values through the pooled correction.

    Parameters
    ----------
    n_quantiles : int | None
        Ladder size (default: min(2048, pooled sample count)).
    sample_per_shard : int
        Sketch size per device on the sharded path.
    mesh : None
        A mesh of more than one device raises (ROADMAP Queue 1 A, "The
        multi-device layer").
    device : str or torch.device
        Where numpy inputs go: the card by default (float32), ``"cpu"`` for
        the input's dtype.  Tensors stay on their own device.  Without a
        card a CUDA device raises.

    ``transform`` maps X -> observed space (x_ladder -> y_ladder);
    ``inverse_transform`` maps back.  Tails clamp to the ladder ends, the
    convention of ``np.interp``.  Both return tensors on the inputs' device.
    """

    _fit_attributes = ["state_"]

    def __init__(self, n_quantiles: int | None = None, sample_per_shard: int = 8192, mesh=None,
                 device="cuda"):
        self.n_quantiles = n_quantiles
        self.sample_per_shard = sample_per_shard
        self.mesh = mesh
        self.device = device

    def _grid(self, a):
        a = as_tensor(a, self.device, type(self).__name__)
        return a[None] if a.ndim == 1 else a

    def fit(self, X, y):
        X = self._grid(X)
        y = self._grid(y).to(X.device)
        dtype = torch.float64 if X.dtype == torch.float64 else torch.float32
        nq = self.n_quantiles
        if nq is None:
            nq = int(min(2048, X.numel(), y.numel()))
        pp = ladder_positions(nq, dtype, X.device)
        x_ladder, n_x = pooled_quantile_table(X.to(dtype), pp, self.mesh,
                                              sample_per_shard=self.sample_per_shard)
        y_ladder, n_y = pooled_quantile_table(y.to(dtype), pp, self.mesh,
                                              sample_per_shard=self.sample_per_shard)
        self.state_ = GlobalQuantileState(pp, x_ladder, y_ladder, n_x, n_y)
        return self

    def _map(self, V, src, dst):
        # each cell row against the one shared ladder: K6 takes the table once
        V = self._grid(V).to(src.dtype)
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
