"""Utilities: calendars, the native host libraries, the prefetching feed,
zarr stores, checkpoints, metrics, disaggregation and profiling.  Exports
the names of ``skdownscale_tpu.utils``; its four modules load on first use
(``checkpoint`` reaches the models, which import this package)."""

import importlib

from .timeindex import PaddedGroups, TimeIndex

__all__ = ["PaddedGroups", "TimeIndex", "checkpoint", "metrics", "native", "profiling"]

_MODULES = ("checkpoint", "metrics", "native", "profiling")


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
