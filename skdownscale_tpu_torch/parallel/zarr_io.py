"""Zarr store -> flat cell ranges: the input side of the pipeline.

Port of ``skdownscale_tpu/parallel/zarr_io.py``.  :class:`ZarrGridSource`
maps a range of the flat (C-order) cell axis of a (time, \\*spatial) zarr
array onto the store's own chunk grid and reads only the covering row band
(host numpy, through this package's :mod:`..utils.zarrlite`).
:func:`feed_zarr_cells` reads only this process's slice of the flat cell
axis (:func:`.multihost.host_cell_slice`) and places it on the mesh
(:func:`.multihost.feed_cells`).
"""

from __future__ import annotations

import numpy as np

from ..utils import zarrlite
from .multihost import feed_cells, host_cell_slice

__all__ = ["ZarrGridSource", "feed_zarr_cells"]


class ZarrGridSource:
    """Lazy (time, \\*spatial) zarr array exposed as a flat cell-range reader.

    Parameters
    ----------
    store : str or mapping
        Path to a zarr (v2 or v3) array, or a group containing ``var`` (and
        optionally a 1-D ``time`` member; ``int64`` time values with attr
        ``{"kind": "datetime64[ns]"}`` round-trip a pandas DatetimeIndex).
        Any dict-like key->bytes mapping works too (a plain dict, an fsspec
        mapper; :mod:`..utils.zarrlite`'s store abstraction).
    var : str, optional
        Group member name (required when the group has several members
        besides ``time``).
    """

    def __init__(self, store, var: str | None = None):
        st = zarrlite._as_store(store)
        if ".zgroup" in st or zarrlite._v3_node_type(st) == "group":
            grp = zarrlite.open_group(st)
            if var is None:
                keys = [k for k in grp.array_keys() if k != "time"]
                if len(keys) != 1:
                    raise ValueError(f"store has members {keys}; pass var=")
                var = keys[0]
            self.array = grp[var]
            self._time = grp["time"] if "time" in grp else None
        else:
            self.array = zarrlite.open_array(st)
            self._time = None
        self.var = var
        self.n_time = self.array.shape[0]
        self.spatial_shape = tuple(self.array.shape[1:])
        self.n_cells = int(np.prod(self.spatial_shape)) if self.spatial_shape else 1

    @property
    def index(self):
        """Time index: the decoded ``time`` member when present, else a range."""
        import pandas as pd

        if self._time is None:
            return pd.RangeIndex(self.n_time)
        vals = np.asarray(self._time)
        if self._time.attrs.get("kind", "").startswith("datetime64"):
            return pd.DatetimeIndex(vals.view("datetime64[ns]"))
        return pd.Index(vals)

    def read_cells(self, lo: int, hi: int, dtype=np.float64) -> np.ndarray:
        """Rows ``[lo, hi)`` of the flat cell axis as a contiguous ``(hi-lo,
        n_time)`` array of ``dtype``, read from the covering band of leading
        spatial rows only.  ``dtype=np.float32`` transposes straight into
        float32, without a float64 copy."""
        dtype = np.dtype(dtype)
        hi = min(hi, self.n_cells)
        if hi <= lo:
            return np.empty((0, self.n_time), dtype)
        if not self.spatial_shape:
            blk = self.array.read_block([0], [self.n_time])[None, :]
            return np.ascontiguousarray(blk.astype(dtype, copy=False))
        rest = int(np.prod(self.spatial_shape[1:])) if len(self.spatial_shape) > 1 else 1
        r0 = lo // rest
        r1 = -(-hi // rest)
        starts = [0, r0] + [0] * (len(self.spatial_shape) - 1)
        stops = [self.n_time, r1] + list(self.spatial_shape[1:])
        blk = self.array.read_block(starts, stops)  # (T, r1-r0, ...)
        flat = blk.reshape(self.n_time, -1)
        off = r0 * rest
        sel = flat[:, lo - off : hi - off]
        return np.ascontiguousarray(sel.T.astype(dtype, copy=False))


def feed_zarr_cells(store, mesh, var: str | None = None):
    """This process's cell slice of a zarr grid, placed on the mesh.

    Returns ``(ShardedCells of the (C_padded, T) grid, n_cells,
    time_index)``; rows past the true cell count (shard padding) are NaN.
    A mesh of CUDA devices reads float32, any other float64.
    """
    src = ZarrGridSource(store, var)
    sl = host_cell_slice(src.n_cells, mesh)
    dtype = np.float32 if mesh.devices[0].type == "cuda" else np.float64
    local = src.read_cells(sl.start, sl.stop, dtype=dtype)
    want = sl.stop - sl.start
    if local.shape[0] < want:  # last process: pad rows past n_cells
        pad = np.full((want - local.shape[0], src.n_time), np.nan, dtype)
        local = np.concatenate([local, pad], axis=0)
    arr, n_cells = feed_cells(local, src.n_cells, mesh)
    return arr, n_cells, src.index
