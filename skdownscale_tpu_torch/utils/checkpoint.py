"""Checkpoint and resume for fitted downscalers, without pickle.

Port of ``skdownscale_tpu/utils/checkpoint.py``.  A fitted state is a tree
of tensors (NamedTuples, tuples, lists and dicts), so a checkpoint is one
``.npz`` file: every array of the tree moved to the host, and a JSON
manifest (stored in the same file as a string array) that holds the
format version, the tree's structure (NamedTuple type names and field
order) and, for :func:`save`, the model class and parameters and the grid
metadata of the fitted ``PointWiseDownscaler``.  :func:`load` and
:func:`load_state` read it with ``np.load(..., allow_pickle=False)``, and
a name in the manifest is only looked up in this package and only as what
its node says it is: a NamedTuple class, an estimator class (a subclass of
``SingleCellEstimator``, built from the file's parameters) or one of the
groupers.  So a file can only build what a fitted model holds.

:func:`load` / :func:`load_state` refuse a newer format version with a
named error, and anything else that is not version 1 as unrecognized.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import torch

from ..parallel.mesh import MULTI_DEVICE_ITEM
from .device import resolve

__all__ = ["save", "load", "save_state", "load_state"]

_FORMAT_VERSION = 1
_PACKAGE = __name__.split(".")[0]
_MANIFEST = "__manifest__"


def _check_version(payload, path):
    v = payload.get("version")
    if v == _FORMAT_VERSION:
        return
    if isinstance(v, int) and v > _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has format version {v}, newer than this "
            f"library's {_FORMAT_VERSION}; upgrade {_PACKAGE} to read it"
        )
    # v1 is the first released format; anything else is not ours
    raise ValueError(f"checkpoint {path!r} has unrecognized format version {v!r}")


def _qualname(obj_type) -> str:
    return f"{obj_type.__module__}.{obj_type.__qualname__}"


def _lookup(name: str):
    """A class or function of this package by its dotted name (nothing
    else is imported)."""
    mod_name, _, cls_name = name.rpartition(".")
    if mod_name != _PACKAGE and not mod_name.startswith(_PACKAGE + "."):
        raise ValueError(f"checkpoint names {name!r}, which is not a name of {_PACKAGE}")
    obj = getattr(importlib.import_module(mod_name), cls_name, None)
    if obj is None:
        raise ValueError(f"checkpoint names {name!r}, which {_PACKAGE} does not have")
    return obj


def _functions() -> dict:
    """The callables a model's parameters may hold: the groupers."""
    from ..models import grouping
    from ..models.groupers import DAY_GROUPER, MONTH_GROUPER, PaddedDOYGrouper

    return {_qualname(f): f for f in
            (MONTH_GROUPER, DAY_GROUPER, PaddedDOYGrouper, grouping.PaddedDOYGrouper)}


def _lookup_as(name: str, kind: str):
    """``name`` looked up, refused unless it is what a ``kind`` node holds."""
    from ..models.base import SingleCellEstimator

    if kind == "function":
        obj = _functions().get(name)
        ok = obj is not None
    else:
        obj = _lookup(name)
        ok = isinstance(obj, type) and (
            issubclass(obj, tuple) and hasattr(obj, "_fields") if kind == "namedtuple"
            else issubclass(obj, SingleCellEstimator))
    if not ok:
        raise ValueError(f"checkpoint names {name!r} as a {kind}, which it is not")
    return obj


class _Writer:
    """Flattens trees into numbered arrays and a JSON-able structure."""

    def __init__(self):
        self.arrays: dict[str, np.ndarray] = {}

    def array(self, a) -> str:
        key = f"a{len(self.arrays)}"
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if a.dtype == object:
            a = a.astype(str)  # names: no pickle on load
        self.arrays[key] = a
        return key

    def tree(self, node):
        if isinstance(node, torch.Tensor):
            return {"tensor": self.array(node)}
        if isinstance(node, np.ndarray):
            return {"ndarray": self.array(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return {"namedtuple": _qualname(type(node)), "fields": list(node._fields),
                    "items": [self.tree(v) for v in node]}
        if isinstance(node, (tuple, list)):
            return {type(node).__name__: [self.tree(v) for v in node]}
        if isinstance(node, dict):
            if not all(isinstance(k, str) for k in node):
                raise TypeError("a checkpointed dict needs string keys")
            return {"dict": {k: self.tree(v) for k, v in node.items()}}
        if node is None or isinstance(node, (bool, int, float, str)):
            return {"value": node}
        if isinstance(node, np.generic):
            return {"value": node.item()}
        if isinstance(node, type) or callable(node) and hasattr(node, "__qualname__"):
            name = _qualname(node)
            if _functions().get(name) is not node:
                raise TypeError(f"cannot checkpoint {name}: of callables only the groupers are")
            return {"function": name}
        from ..models.base import SingleCellEstimator

        if isinstance(node, SingleCellEstimator):
            return {"estimator": _qualname(type(node)),
                    "params": {k: self.tree(v) for k, v in node.get_params().items()}}
        raise TypeError(f"cannot checkpoint a {type(node).__name__}")

    def index(self, index):
        """A time index or coordinate (a DatetimeIndex, the calendar
        ``TimeIndex``, another pandas Index, an array) as arrays."""
        import pandas as pd

        from .timeindex import TimeIndex

        if isinstance(index, TimeIndex):
            return {"timeindex": {f: self.array(getattr(index, f)) for f in
                                  ("month", "day", "dayofyear", "year", "is_leap_year")}}
        if isinstance(index, pd.DatetimeIndex):
            return {"datetime": self.array(np.asarray(index, dtype="datetime64[ns]"))}
        if isinstance(index, pd.Index):
            return {"index": self.array(np.asarray(index))}
        return {"ndarray": self.array(index)}

    def save(self, path, manifest: dict) -> None:
        manifest = {"version": _FORMAT_VERSION, **manifest}
        with open(path, "wb") as f:
            np.savez(f, **{_MANIFEST: np.array(json.dumps(manifest))}, **self.arrays)


class _Reader:
    def __init__(self, path):
        with np.load(path, allow_pickle=False) as z:
            self.arrays = {k: z[k] for k in z.files}
        raw = self.arrays.pop(_MANIFEST, None)
        self.manifest = json.loads(str(raw)) if raw is not None else {}
        _check_version(self.manifest, path)

    def tree(self, node, device, to_float32=False):
        kind = next(iter(node))
        val = node[kind]
        if kind == "tensor":
            t = torch.from_numpy(self.arrays[val].copy())
            if to_float32 and t.is_floating_point():
                t = t.float()
            return t.to(device)
        if kind == "ndarray":
            return self.arrays[val]
        if kind == "namedtuple":
            cls = _lookup_as(val, kind)
            fields = node["fields"]
            if list(cls._fields) != fields:
                raise ValueError(f"checkpoint's {val} has fields {fields}, this package's {list(cls._fields)}")
            to_float32 = to_float32 and not getattr(cls, "float64_on_every_device", False)
            return cls(*(self.tree(v, device, to_float32) for v in node["items"]))
        if kind in ("tuple", "list"):
            items = [self.tree(v, device, to_float32) for v in val]
            return tuple(items) if kind == "tuple" else items
        if kind == "dict":
            return {k: self.tree(v, device, to_float32) for k, v in val.items()}
        if kind == "value":
            return val
        if kind == "function":
            return _lookup_as(val, kind)
        if kind == "estimator":
            cls = _lookup_as(val, kind)
            return cls(**{k: self.tree(v, device) for k, v in node["params"].items()})
        raise ValueError(f"checkpoint holds an unknown node {kind!r}")

    def index(self, node):
        import pandas as pd

        from .timeindex import TimeIndex

        (kind, val), = node.items()
        if kind == "timeindex":
            return TimeIndex(**{f: self.arrays[k] for f, k in val.items()})
        if kind == "datetime":
            return pd.DatetimeIndex(self.arrays[val])
        if kind == "index":
            return pd.Index(self.arrays[val])
        return self.arrays[val]


def save_state(path: str, state) -> None:
    """Save a fitted state (a tree of tensors) to ``path``."""
    w = _Writer()
    w.save(path, {"state": w.tree(state)})


def load_state(path: str, device="cuda"):
    """The state saved by :func:`save_state`, its tensors on ``device`` in
    their saved dtypes."""
    dev = resolve(device, "load_state")
    r = _Reader(path)
    return r.tree(r.manifest["state"], dev)


def save(path: str, downscaler) -> None:
    """Checkpoint a fitted ``PointWiseDownscaler`` (batched models only)."""
    if downscaler._state is None:
        raise ValueError(
            "only batched-model downscalers are checkpointable (per-cell "
            "fallback estimators hold arbitrary Python objects)"
        )
    w = _Writer()
    model = downscaler._model
    meta = downscaler._px_meta
    manifest = {
        "model": w.tree(model),
        "model_extra": {
            k: w.tree(v) for k, v in vars(model).items()
            if k.endswith("_") and np.isscalar(v)
        },
        "dim": downscaler._dim,
        "device": downscaler.device.type,
        "cell_chunk_size": downscaler.cell_chunk_size,
        "px_meta": {
            "spatial_dims": list(meta["spatial_dims"]),
            "spatial_shape": [int(n) for n in meta["spatial_shape"]],
            "n_cells": int(meta["n_cells"]),
            "coords": {k: w.index(v) for k, v in meta["coords"].items()},
        },
        "mask": w.array(downscaler._mask),
        "cell_ids": w.array(downscaler._cell_ids),
        "state_plan": [w.array(ids) for ids in downscaler._state_plan],
        "fit_index": w.index(downscaler._fit_index),
        "state": w.tree(list(downscaler._state)),
    }
    w.save(path, manifest)


def load(path: str, sharding=None, device="cuda"):
    """Restore a fitted ``PointWiseDownscaler`` from :func:`save` output,
    its state on ``device`` in the dtypes it was saved in.  A state saved
    from a CPU run and loaded on a CUDA device is cast to float32, as the
    runner fits there, except a state that keeps float64 on every device
    (``float64_on_every_device``, ARRM's).  ``sharding`` waits for the
    multi-device layer."""
    if sharding is not None:
        raise NotImplementedError(
            "load(sharding=...) waits for the port of the multi-device layer "
            f"({MULTI_DEVICE_ITEM}); pass device= to load on one device"
        )
    from ..pointwise import PointWiseDownscaler
    from ..xlite import DataArray as _DA

    dev = resolve(device, "load")
    r = _Reader(path)
    m = r.manifest
    model = r.tree(m["model"], dev)
    for k, v in m["model_extra"].items():
        if k.startswith("_") or not k.endswith("_") or "value" not in v:
            raise ValueError(f"checkpoint sets {k!r}, which is not a fitted scalar attribute")
        setattr(model, k, v["value"])

    d = PointWiseDownscaler(model, dim=m["dim"], device=dev, cell_chunk_size=m["cell_chunk_size"])
    px = m["px_meta"]
    d._px_meta = {
        "spatial_dims": tuple(px["spatial_dims"]),
        "spatial_shape": tuple(px["spatial_shape"]),
        "n_cells": px["n_cells"],
        "coords": {k: r.index(v) for k, v in px["coords"].items()},
    }
    d._mask = r.arrays[m["mask"]]
    d._cell_ids = r.arrays[m["cell_ids"]]
    d._state_plan = [r.arrays[k] for k in m["state_plan"]]
    d._fit_index = r.index(m["fit_index"])
    d._maker = lambda data, dims, coords: _DA(data, dims, coords)
    d._state = r.tree(m["state"], dev, to_float32=dev.type == "cuda" and m["device"] == "cpu")
    d._models = None
    return d
