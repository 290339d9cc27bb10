"""Grid front-end for the global (pooled) models.

Port of ``skdownscale_tpu/global_models/downscaler.py`` on one device:
accepts ``xlite``/xarray DataArrays (time + spatial dims) or bare (cells,
time) arrays, moves the grid to ``device``, flattens space to the leading
cell axis there and reshapes outputs back to the grid.  NaN cells (oceans) pass
through: they carry zero weight in pooled fits and map to NaN in outputs.
"""

from __future__ import annotations

import numpy as np

from ..xlite import is_dataarray as _is_dataarray
from ._device import MULTI_DEVICE_ITEM, as_tensor

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
    sharding : not supported yet; passing one raises.
    """

    def __init__(self, model, dim: str = "time", device="cuda", sharding=None):
        if sharding is not None:
            raise NotImplementedError(
                f"GlobalDownscaler(sharding=...) waits for the multi-device layer "
                f"({MULTI_DEVICE_ITEM}); pass device= to run on one device"
            )
        self._model = model
        self._dim = dim
        self.device = device

    # -- packing -------------------------------------------------------
    def _pack(self, X):
        """-> (cells, time[, f]) tensor on the device + unpack metadata.  A
        DataArray moves to the device time-first, as it is laid out, and is
        transposed there (a host transpose of a continental grid is a
        slow strided copy)."""
        who = type(self).__name__
        if _is_dataarray(X):
            dims = list(X.dims)
            if self._dim not in dims:
                raise ValueError(f"dimension {self._dim!r} not in {dims}")
            arr = np.moveaxis(np.asarray(X.data), dims.index(self._dim), 0)  # (T, spatial...)
            grid = as_tensor(arr.reshape(arr.shape[0], -1), self.device, who).T.contiguous()
            return grid, (arr.shape[1:], [d for d in dims if d != self._dim], X)
        arr = np.asarray(X)
        if arr.ndim == 1:
            arr = arr[None, :]
        # bare arrays are already (cells, time[, features])
        return as_tensor(arr, self.device, who), ((arr.shape[0],), None, None)

    def _unpack(self, out, meta):
        out = out.cpu().numpy()
        spatial, other_dims, template = meta
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
            return dx[..., None]
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
        return f"GlobalDownscaler(model={self._model!r}, dim={self._dim!r}, device={self.device!r})"
