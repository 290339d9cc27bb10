"""Minimal labeled-array containers (xarray-compatible subset).

Host copy of ``skdownscale_tpu/xlite.py``.  :mod:`skdownscale_tpu_torch.pointwise`
duck-types its inputs: anything exposing ``dims`` / ``coords`` / ``values``
works, real ``xarray.DataArray`` objects when xarray is installed, or these
stand-ins otherwise.  Outputs are built with the input's own type.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = ["DataArray", "Dataset", "is_dataarray", "is_dataset"]


class DataArray:
    """A labeled N-D array: ``data`` + ``dims`` + per-dim ``coords``."""

    def __init__(self, data, dims, coords: Mapping[str, Any] | None = None, name=None):
        self.data = np.asarray(data) if not hasattr(data, "dtype") else data
        self.dims = tuple(dims)
        if len(self.dims) != np.ndim(self.data):
            raise ValueError(f"dims {self.dims} do not match data ndim {np.ndim(self.data)}")
        self.coords = dict(coords or {})
        self.name = name
        for d, c in self.coords.items():
            if d in self.dims:
                axis = self.dims.index(d)
                if len(c) != self.data.shape[axis]:
                    raise ValueError(f"coord {d} has length {len(c)} != {self.data.shape[axis]}")

    @property
    def values(self):
        return np.asarray(self.data)

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.data.shape))

    def get_axis_num(self, dim):
        return self.dims.index(dim)

    def transpose(self, *dims):
        if not dims:
            dims = tuple(reversed(self.dims))
        if set(dims) != set(self.dims):
            raise ValueError(f"transpose dims {dims} != {self.dims}")
        axes = [self.dims.index(d) for d in dims]
        return DataArray(np.transpose(self.values, axes), dims, self.coords, name=self.name)

    def expand_dims(self, dim, labels, axis=0):
        data = np.expand_dims(self.values, axis)
        data = np.repeat(data, len(labels), axis=axis) if len(labels) > 1 else data
        dims = list(self.dims)
        dims.insert(axis, dim)
        coords = dict(self.coords)
        coords[dim] = list(labels)
        return DataArray(data, dims, coords, name=self.name)

    def isel(self, **sel):
        data = self.values
        dims = list(self.dims)
        coords = dict(self.coords)
        for d, i in sel.items():
            axis = dims.index(d)
            data = np.take(data, i, axis=axis)
            if np.isscalar(i) or np.ndim(i) == 0:
                dims.pop(axis)
                coords.pop(d, None)
            elif d in coords:
                coords[d] = np.asarray(coords[d])[i]
        return DataArray(data, dims, coords, name=self.name)

    def __repr__(self):
        return f"<skdownscale_tpu_torch.DataArray {self.name or ''} {self.sizes}>"


class Dataset:
    """A dict of same-grid DataArrays, convertible to a stacked DataArray."""

    def __init__(self, data_vars: Mapping[str, DataArray]):
        self.data_vars = dict(data_vars)

    def to_array(self, dim: str = "variable") -> DataArray:
        names = list(self.data_vars)
        first = self.data_vars[names[0]]
        stacked = np.stack([np.asarray(self.data_vars[n].values) for n in names], axis=0)
        dims = (dim, *first.dims)
        coords = dict(first.coords)
        coords[dim] = names
        return DataArray(stacked, dims, coords)

    def __getitem__(self, key):
        return self.data_vars[key]

    @property
    def dims(self):
        out = {}
        for da in self.data_vars.values():
            out.update(da.sizes)
        return out


def is_dataarray(obj) -> bool:
    """True for xarray.DataArray or xlite.DataArray (duck-typed)."""
    return hasattr(obj, "dims") and hasattr(obj, "values") and not is_dataset(obj)


def is_dataset(obj) -> bool:
    return hasattr(obj, "data_vars") and hasattr(obj, "to_array")
