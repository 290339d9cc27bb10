"""Gridded ("pointwise") downscaling runtime on one torch device.

Port of ``skdownscale_tpu/pointwise.py``, re-designing the reference's
``PointWiseDownscaler`` (``pointwise_models/core.py:200-448``).  The
reference broadcasts a scikit-learn estimator over every grid cell with a
Python loop; here the grid is packed once into ``(cells, time, features)``
arrays, NaN (ocean/missing) cells are compacted out, and the model's batched
implementation (:mod:`.models.batched`) fits and predicts all cells of a
chunk at once on the runner's device.

Inputs duck-type xarray: real ``xarray.DataArray``/``Dataset`` objects, or
:mod:`skdownscale_tpu_torch.xlite` containers; outputs are built with the
input's own type.  Estimators without a batched implementation (sklearn
estimators and Pipelines, or a registered model whose ``accepts`` refuses
the instance, such as a ``TrendAwareQuantileMappingRegressor`` with a
custom trend transformer) fall back to the reference-style per-cell object
loop, host-driven as in the JAX package: a deep copy of the model is fit to
each valid cell's pandas frame, and an estimator of this package inside it
runs on its own ``single_cell_device``.
"""

from __future__ import annotations

import copy
import warnings

import numpy as np
import torch

from .models import batched as _b
from .utils import native as _native
from .utils.prefetch import prefetched
from .utils.timeindex import TimeIndex
from .xlite import DataArray as _XliteDataArray
from .xlite import is_dataarray, is_dataset

DEFAULT_FEATURE_DIM = "variable"

__all__ = ["PointWiseDownscaler", "DEFAULT_FEATURE_DIM"]


def _dataarray_type(X):
    """Constructor for outputs matching the input's type (xarray DataArray,
    or the xlite container).  Both accept (data, dims=, coords=)."""
    t = type(X)
    maker = t if t.__module__.startswith("xarray") else _XliteDataArray
    return lambda data, dims, coords: maker(
        data, dims=dims, coords={k: v for k, v in coords.items() if k in dims}
    )


def _time_index(coord, n):
    """Convert a time coordinate to a pandas DatetimeIndex when possible; a
    ``TimeIndex`` coord (non-pandas climate calendars) passes through."""
    import pandas as pd

    if coord is None:
        warnings.warn("X does not have a time coordinate, making one up...")
        return pd.date_range(start="1950", periods=n, freq="MS")
    if isinstance(coord, TimeIndex):
        return coord
    try:
        return pd.DatetimeIndex(np.asarray(coord))
    except (TypeError, ValueError):
        return pd.Index(np.asarray(coord))


class PointWiseDownscaler:
    """Apply a downscaling estimator over every cell of a labeled grid.

    Parameters
    ----------
    model : estimator
        Any object with the scikit-learn fit/predict API.  An estimator of
        this package with a batched implementation (``BcsdTemperature``,
        ``BcsdPrecipitation``, ``LinearTrendTransformer``,
        ``CunnaneTransformer``, ``QuantileMapper``, ``QuantileMappingReressor``,
        ``EquidistantCdfMatcher``, ``TrendAwareQuantileMappingRegressor``,
        ``ZScoreRegressor``, ``PiecewiseLinearRegression``, ``PureAnalog``,
        ``AnalogRegression``, ``PureRegression``) runs every cell of a chunk
        at once on ``device``; any other model takes the per-cell loop.
        ``predict`` and ``transform`` may take a time axis of another length
        than ``fit`` where the model allows it (the quantile regressors and
        the GARD family).  A model with several outputs (the GARD family's
        ``pred``, ``exceedance_prob``, ``prediction_error``) predicts a
        ``(time, variable, *spatial)`` array with the output names as the
        ``variable`` coordinate.
    dim : str
        Time dimension name (default ``'time'``).
    device : str or torch.device
        Where a batched model fits and predicts the grid.  On a CUDA device
        the grid is moved in float32 and the hand-written kernels run; on
        the CPU the input dtype is kept (float64 stays float64).  Never
        chosen by probing.
    cell_chunk_size : int, optional
        Process (and hold state for) at most this many valid cells per
        device pass, bounding device memory.
    """

    def __init__(self, model, dim: str = "time", device="cuda", cell_chunk_size=None):
        if not hasattr(model, "fit"):
            raise TypeError(
                f"Type {type(model)} does not have the fit method required by PointWiseDownscaler"
            )
        self._dim = dim
        self._model = model
        self._state = None  # list of per-chunk batched states
        self._state_plan = None  # list of valid-cell id chunks
        self._models = None  # per-cell object array (fallback path)
        self.device = torch.device(device)
        self.cell_chunk_size = cell_chunk_size

    # ------------------------------------------------------------------
    # packing
    # ------------------------------------------------------------------
    def _to_feature_x(self, X, feature_dim=DEFAULT_FEATURE_DIM):
        """Mirror of ``core.py:427-440``: Dataset -> feature DataArray,
        ensure the feature dim, transpose to (time, variable, ...)."""
        if is_dataset(X):
            X = X.to_array(feature_dim)
        if feature_dim not in X.dims:
            if type(X).__module__.startswith("xarray"):
                X = X.expand_dims(**{feature_dim: [f"{feature_dim}_0"]}, axis=1)
            else:
                X = X.expand_dims(feature_dim, [f"{feature_dim}_0"], axis=1)
        rest = [d for d in X.dims if d not in (self._dim, feature_dim)]
        return X.transpose(self._dim, feature_dim, *rest)

    def _pack(self, X):
        """(time, variable, *spatial) DataArray -> contiguous (T, F, C) array
        + metadata."""
        arr = np.asarray(X.values)
        if arr.dtype not in (np.float32, np.float64):
            arr = arr.astype(float)
        T, F = arr.shape[0], arr.shape[1]
        spatial_shape = arr.shape[2:]
        C = int(np.prod(spatial_shape)) if spatial_shape else 1
        coords = dict(X.coords)
        return {
            "flat": np.ascontiguousarray(arr.reshape(T, F, C)),
            "T": T,
            "F": F,
            "spatial_dims": tuple(X.dims[2:]),
            "spatial_shape": spatial_shape,
            "coords": coords,
            "index": _time_index(coords.get(self._dim), T),
            "n_cells": C,
        }

    def _device_dtype(self, dtype):
        """float32 on CUDA (as the JAX package ran an accelerator with x64
        off); the input dtype on the CPU."""
        if self.device.type == "cuda":
            return np.float32
        return dtype

    def _to_device(self, flat, ids):
        """(T, F, C) host grid -> (n_ids, T, F) tensor on the runner's device."""
        packed = _native.pack_compact(flat, ids)
        packed = packed.astype(self._device_dtype(packed.dtype), copy=False)
        return torch.from_numpy(packed).to(self.device)

    def _plan_chunks(self):
        """Valid-cell id chunks split by ``cell_chunk_size``, in ascending
        order, so per-chunk outputs concatenate back in ``_cell_ids`` order."""
        ids = self._cell_ids
        step = self.cell_chunk_size or max(len(ids), 1)
        return [ids[i : i + step] for i in range(0, len(ids), step)]

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, X, *args, **kwargs):
        if len(args) > 1:
            raise ValueError(f"Expected at most 1 positional argument, got {len(args)}")
        y = args[0] if args else None
        feature_dim = kwargs.pop("feature_dim", DEFAULT_FEATURE_DIM)

        Xf = self._to_feature_x(X, feature_dim)
        px = self._pack(Xf)

        # cell mask from the first (time, variable) slice (core.py:35-37)
        mask = _native.valid_mask(px["flat"][0, 0])
        self._mask = mask
        self._cell_ids = np.nonzero(mask)[0].astype(np.int32)
        self._px_meta = {k: px[k] for k in ("spatial_dims", "spatial_shape", "coords", "n_cells")}
        self._fit_index = px["index"]
        self._maker = _dataarray_type(X if is_dataarray(X) else Xf)

        py = None
        if y is not None:
            py = self._pack(self._to_feature_x(y, feature_dim))
            if py["F"] != 1:
                raise ValueError("y must have a single variable")
            if py["n_cells"] != px["n_cells"] or py["T"] != px["T"]:
                raise ValueError(
                    f"X and y grids do not align: X has {px['T']} time steps x "
                    f"{px['n_cells']} cells, y has {py['T']} x {py['n_cells']}"
                )
            if isinstance(px["index"], TimeIndex) or isinstance(py["index"], TimeIndex):
                same = px["index"] == py["index"]
            else:
                same = np.array_equal(np.asarray(px["index"]), np.asarray(py["index"]))
            if not same:
                # reference estimators assert X/y index equality (base.py:17)
                raise ValueError("X and y must share an identical time index")

        if not _b.supports_batched(self._model):
            self._fit_fallback(px, py)
            return self
        self._models = None
        self._state_plan = self._plan_chunks()

        def _prep(ids):
            xd = self._to_device(px["flat"], ids)
            yd = self._to_device(py["flat"], ids)[:, :, 0] if py is not None else None
            return xd, yd

        # double-buffered host feed: pack + copy chunk i+1 while the device
        # fits chunk i
        self._state = [
            _b.batched_fit(self._model, self._fit_index, xd, yd)
            for xd, yd in prefetched(self._state_plan, _prep)
        ]
        return self

    # ------------------------------------------------------------------
    # per-cell object fallback
    # ------------------------------------------------------------------
    def _feature_names(self):
        names = self._px_meta["coords"].get(DEFAULT_FEATURE_DIM)
        if names is None:
            return [f"{DEFAULT_FEATURE_DIM}_0"]
        return list(np.asarray(names))

    def _cell_df(self, flat, c, index):
        """One cell of a (T, F, C) host grid as a (T, F) pandas frame."""
        import pandas as pd

        return pd.DataFrame(flat[:, :, c], index=index, columns=self._feature_names())

    def _fit_fallback(self, px, py):
        """A deep copy of the model fit to each valid cell, in a host loop
        (``pointwise.py:354-375`` of the JAX package)."""
        import pandas as pd

        models = np.full(px["n_cells"], None, dtype=object)
        for c in self._cell_ids:
            mod = copy.deepcopy(self._model)
            xdf = self._cell_df(px["flat"], c, self._fit_index)
            if py is not None:
                models[c] = mod.fit(xdf, pd.DataFrame(py["flat"][:, 0, c], index=self._fit_index))
            else:
                models[c] = mod.fit(xdf)
        self._models = models
        self._state = self._state_plan = None

    def _per_cell(self, px, method, n_outputs=1):
        """``method`` of each fitted cell's model on its frame of ``px``:
        (valid cells, T, n_outputs) on the host."""
        T = px["T"]
        rows = [
            np.asarray(getattr(self._models[c], method)(self._cell_df(px["flat"], c, px["index"])))
            for c in self._cell_ids
        ]
        return np.stack([r.reshape(T, n_outputs) for r in rows]) if rows else np.zeros((0, T, n_outputs))

    def _check_fitted(self):
        if self._state is None and self._models is None:
            raise ValueError("PointWiseDownscaler is not fitted; call fit first")

    # ------------------------------------------------------------------
    # predict
    # ------------------------------------------------------------------
    def _n_outputs(self):
        """(n_outputs, output_names) of the model: 1 and None unless it
        declares several (the GARD family's three columns)."""
        try:
            return self._model.n_outputs, list(self._model.output_names)
        except AttributeError:
            return 1, None

    def predict(self, X, **kwargs):
        self._check_fitted()
        feature_dim = kwargs.pop("feature_dim", DEFAULT_FEATURE_DIM)
        Xf = self._to_feature_x(X, feature_dim)
        px = self._pack(Xf)
        T = px["T"]
        n_outputs, output_names = self._n_outputs()
        unpacked = self._run_chunks(
            px,
            lambda st, xd: _b.batched_predict(self._model, st, self._fit_index, xd, px["index"]),
            "predict",
            n_outputs,
        )  # (T, n_outputs, C)
        coords = dict(px["coords"])
        if n_outputs == 1:
            data = unpacked[:, 0].reshape(T, *px["spatial_shape"])
            dims = (self._dim, *px["spatial_dims"])
            coords.pop(feature_dim, None)
        else:
            data = unpacked.reshape(T, n_outputs, *px["spatial_shape"])
            dims = (self._dim, feature_dim, *px["spatial_dims"])
            coords[feature_dim] = output_names
        return _dataarray_type(X if is_dataarray(X) else Xf)(data, dims, coords)

    def _run_chunks(self, px, run, method, n_outputs=1):
        """``run(state, x)`` on every chunk of ``px``'s fitted cells
        (double-buffered host feed), each giving (cells, T) or (cells, T,
        n_outputs), or the fitted models' ``method`` cell by cell on the
        fallback path, unpacked to a (T, n_outputs, C) host grid with NaN in
        the cells the fit dropped."""
        T, C = px["T"], px["n_cells"]
        if self._state is None:
            outs = [self._per_cell(px, method, n_outputs)]
        else:
            outs = [
                run(st, xd).cpu().numpy()
                for st, xd in zip(
                    self._state,
                    prefetched(self._state_plan, lambda ids: self._to_device(px["flat"], ids)),
                )
            ]
        if len(outs) == 1:
            out_v = outs[0]  # one chunk: no full-size host copy
        else:
            out_v = np.concatenate(outs, axis=0) if outs else np.zeros((0, T, n_outputs), px["flat"].dtype)
        nv = len(self._cell_ids)
        return _native.unpack_scatter(
            out_v.reshape(nv, T, n_outputs).astype(px["flat"].dtype, copy=False), self._cell_ids, C
        )

    # ------------------------------------------------------------------
    # transform / inverse_transform
    # ------------------------------------------------------------------
    def transform(self, X, **kwargs):
        return self._transform(X, "transform", **kwargs)

    def inverse_transform(self, X, **kwargs):
        return self._transform(X, "inverse_transform", **kwargs)

    def _transform(self, X, direction, **kwargs):
        self._check_fitted()
        feature_dim = kwargs.pop("feature_dim", DEFAULT_FEATURE_DIM)
        Xf = self._to_feature_x(X, feature_dim)
        px = self._pack(Xf)
        unpacked = self._run_chunks(
            px,
            lambda st, xd: _b.batched_transform(
                self._model, st, self._fit_index, xd, px["index"], direction
            ),
            direction,
        )  # (T, 1, C)
        dims = Xf.dims
        return _dataarray_type(X if is_dataarray(X) else Xf)(
            unpacked.reshape([Xf.sizes[d] for d in dims]), dims, dict(px["coords"])
        )

    # ------------------------------------------------------------------
    # fitted-attribute access
    # ------------------------------------------------------------------
    def get_attr(self, key: str, dtype=None, template_output=None):
        """Gather a fitted attribute from every cell (``core.py:405-425``)."""
        self._check_fitted()
        meta = self._px_meta
        C = meta["n_cells"]
        mask = self._mask

        if self._state is None:
            vals = np.asarray([getattr(self._models[c], key) for c in self._cell_ids])
        else:
            chunks = [_b.batched_attrs(self._model, st) for st in self._state]
            if key not in chunks[0]:
                raise AttributeError(
                    f"attribute {key!r} is not exposed by the batched "
                    f"implementation of {type(self._model).__name__}; "
                    f"available: {sorted(chunks[0])}"
                )
            vals = np.concatenate([np.asarray(c[key]) for c in chunks], axis=0)  # (Cv, ...)
        extra_shape = vals.shape[1:]

        full = np.full((C, *extra_shape), np.nan, dtype=dtype or float)
        full[mask] = vals
        spatial = meta["spatial_shape"]
        if extra_shape:
            data = np.moveaxis(full.reshape(C, -1), 0, 1).reshape(*extra_shape, *spatial)
        else:
            data = full.reshape(spatial)

        if template_output is not None:
            tdims = tuple(template_output.dims)
            tcoords = dict(getattr(template_output, "coords", {}))
            return _dataarray_type(template_output)(
                data.reshape([template_output.sizes[d] for d in tdims]), tdims, tcoords
            )
        dims = meta["spatial_dims"]
        extra_dims = tuple(f"dim_{i}" for i in range(len(extra_shape)))
        coords = {k: v for k, v in meta["coords"].items() if k in dims}
        return self._maker(data, (*extra_dims, *dims), coords)

    def __repr__(self):
        return "\n".join(
            [
                f"<skdownscale_tpu_torch.{type(self).__name__}>",
                f"  Fit Status: {self._state is not None or self._models is not None}",
                f"  Device: {self.device}",
                f"  Model:\n    {self._model}",
            ]
        )
