"""Grid front-end for the global (pooled) models.

Port of ``skdownscale_tpu/global_models/downscaler.py``: accepts
``xlite``/xarray DataArrays (time + spatial dims) or bare (cells, time)
arrays, flattens space to the leading cell axis, moves the grid to
``device`` or shards it over a cell mesh (``parallel.mesh.shard_cells``:
NaN pad cells, contiguous blocks), and reshapes outputs back to the grid.
NaN cells (oceans) pass through: they carry zero weight in pooled fits and
map to NaN in outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import ShardedCells, as_mesh, shard_cells, to_shard
from ..utils.device import as_tensor
from ..xlite import is_dataarray as _is_dataarray

__all__ = ["GlobalDownscaler"]


class GlobalDownscaler:
    """Wrap a global model (``GlobalLinearRegressor``,
    ``GlobalQuantileMapper``) for gridded input.

    Parameters
    ----------
    model : object with fit/predict or fit/transform on (cells, time[, f])
    dim : str
        Name of the sample (time) dimension in DataArray input.
    device : str or torch.device
        Where the grid is fit and mapped: the card by default (float32),
        ``"cpu"`` for the input's dtype.  Without a card a CUDA device
        raises.
    sharding : CellMesh | MeshSharding | None
        Cell mesh (in place of ``device``): input grids are padded and
        cell-sharded over it, and a model with a ``mesh`` (the quantile
        mapper) fits by the sketch on it.
    """

    def __init__(self, model, dim: str = "time", device="cuda", sharding=None):
        self._model = model
        self._dim = dim
        self.device = device
        self._mesh = None if sharding is None else as_mesh(sharding)
        if self._mesh is not None and hasattr(model, "mesh"):
            model.mesh = self._mesh

    # -- packing -------------------------------------------------------
    def _shard_time_first(self, flat):
        """``shard_cells`` of the cells of a (T, C) grid: each shard's block
        of columns moves to its device time-first, as it is laid out, and is
        transposed there (a host transpose of a continental grid is a slow
        strided copy); NaN pad cells up to a multiple of the mesh size."""
        mesh = self._mesh
        T, C = flat.shape
        rows = -(-C // mesh.size)
        shards = []
        for k, dev in zip(mesh.local_shards, mesh.devices):
            blk = to_shard(flat[:, k * rows:(k + 1) * rows], dev).T
            pad = blk.new_full((rows - blk.shape[0], T), float("nan"))
            shards.append(torch.cat([blk, pad]) if len(pad) else blk.contiguous())
        return ShardedCells(mesh, shards, (rows * mesh.size, T))

    def _pack(self, X):
        """-> (cells, time[, f]) tensor on the device, or ShardedCells on the
        mesh, + unpack metadata.  A DataArray moves to the device (each
        shard's to its device) time-first, as it is laid out, and is
        transposed there (a host transpose of a continental grid is a slow
        strided copy)."""
        who = type(self).__name__
        if _is_dataarray(X):
            dims = list(X.dims)
            if self._dim not in dims:
                raise ValueError(f"dimension {self._dim!r} not in {dims}")
            arr = np.moveaxis(np.asarray(X.data), dims.index(self._dim), 0)  # (T, spatial...)
            meta = (arr.shape[1:], [d for d in dims if d != self._dim], X)
            flat = arr.reshape(arr.shape[0], -1)
            if self._mesh is not None:
                return self._shard_time_first(flat), meta
            return as_tensor(flat, self.device, who).T.contiguous(), meta
        arr = np.asarray(X)
        if arr.ndim == 1:
            arr = arr[None, :]
        # bare arrays are already (cells, time[, features])
        meta = ((arr.shape[0],), None, None)
        if self._mesh is not None:
            return shard_cells(arr, self._mesh)[0], meta
        return as_tensor(arr, self.device, who), meta

    def _unpack(self, out, meta):
        spatial, other_dims, template = meta
        out = out.gather() if isinstance(out, ShardedCells) else out.cpu().numpy()
        out = out[:int(np.prod(spatial))]  # drop the mesh's pad cells
        grid = out.reshape(*spatial, out.shape[-1])
        if template is None:
            return grid
        # rebuild a DataArray with time last (canonical output layout)
        cls = type(template)
        coords = {d: template.coords[d] for d in template.coords if d != self._dim}
        if self._dim in template.coords:
            coords[self._dim] = template.coords[self._dim]
        return cls(grid, dims=(*other_dims, self._dim), coords=coords)

    # -- public API ----------------------------------------------------
    def _maybe_featureize(self, dx):
        # regression models want a trailing feature axis; a (cells, time)
        # grid means one feature
        if hasattr(self._model, "predict") and dx.ndim == 2:
            return dx.map(lambda s: s[..., None]) if isinstance(dx, ShardedCells) else dx[..., None]
        return dx

    def fit(self, X, y, **kwargs):
        dx, _ = self._pack(X)
        dy, _ = self._pack(y)
        self._model.fit(self._maybe_featureize(dx), dy, **kwargs)
        return self

    def _apply(self, method, X, **kwargs):
        dx, meta = self._pack(X)
        if method == "predict":
            dx = self._maybe_featureize(dx)
        return self._unpack(getattr(self._model, method)(dx, **kwargs), meta)

    def predict(self, X, **kwargs):
        return self._apply("predict", X, **kwargs)

    def transform(self, X, **kwargs):
        return self._apply("transform", X, **kwargs)

    def inverse_transform(self, X, **kwargs):
        return self._apply("inverse_transform", X, **kwargs)

    def __repr__(self):
        where = f"device={self.device!r}" if self._mesh is None else f"sharding={self._mesh!r}"
        return f"GlobalDownscaler(model={self._model!r}, dim={self._dim!r}, {where})"
