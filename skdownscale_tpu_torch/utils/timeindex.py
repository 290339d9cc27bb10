"""Host-side calendar features for a time axis.

Host copy of ``skdownscale_tpu/utils/timeindex.py`` (``TimeIndex`` and
``PaddedGroups``): group structure is built once on the host as plain numpy
arrays and uploaded to the device as index tensors by the callers.  Nothing
in this module touches torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["TimeIndex", "PaddedGroups"]


@dataclasses.dataclass(frozen=True)
class TimeIndex:
    """Static calendar features of a time axis (host data).

    Attributes mirror the ``pandas.DatetimeIndex`` accessors the reference
    uses.  All arrays have shape ``(n,)``.
    """

    month: np.ndarray  # int32, 1..12
    day: np.ndarray  # int32, 1..31 (day of month)
    dayofyear: np.ndarray  # int32, 1..366
    year: np.ndarray  # int32
    is_leap_year: np.ndarray  # bool

    def __post_init__(self):
        n = len(self.month)
        for f in dataclasses.fields(self):
            arr = getattr(self, f.name)
            if len(arr) != n:
                raise ValueError(f"TimeIndex field {f.name} has length {len(arr)} != {n}")

    def __len__(self) -> int:
        return len(self.month)

    # TimeIndex participates in table-cache keys.
    def __hash__(self) -> int:
        return hash((len(self), self.month.tobytes(), self.dayofyear.tobytes(), self.year.tobytes()))

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, TimeIndex):
            return NotImplemented
        return (
            len(self) == len(other)
            and np.array_equal(self.month, other.month)
            and np.array_equal(self.day, other.day)
            and np.array_equal(self.dayofyear, other.dayofyear)
            and np.array_equal(self.year, other.year)
            and np.array_equal(self.is_leap_year, other.is_leap_year)
        )

    @classmethod
    def from_pandas(cls, index) -> "TimeIndex":
        """Build from a pandas DatetimeIndex (or anything with dt accessors)."""
        import pandas as pd

        index = pd.DatetimeIndex(index)
        return cls(
            month=np.asarray(index.month, dtype=np.int32),
            day=np.asarray(index.day, dtype=np.int32),
            dayofyear=np.asarray(index.dayofyear, dtype=np.int32),
            year=np.asarray(index.year, dtype=np.int32),
            is_leap_year=np.asarray(index.is_leap_year, dtype=bool),
        )

    @classmethod
    def from_components(cls, year, month, day, calendar: str = "standard") -> "TimeIndex":
        """Build from integer (year, month, day) arrays under a climate
        calendar: 'standard' (proleptic Gregorian leap rule), 'noleap'
        ('365_day'), 'all_leap' ('366_day') or '360_day'."""
        year = np.asarray(year, dtype=np.int32)
        month = np.asarray(month, dtype=np.int32)
        day = np.asarray(day, dtype=np.int32)
        cal = {"365_day": "noleap", "366_day": "all_leap"}.get(calendar, calendar)
        if cal not in ("standard", "noleap", "all_leap", "360_day"):
            raise ValueError(f"unknown calendar: {calendar!r}")
        if cal == "360_day":
            doy = (month - 1) * 30 + day
            leap = np.zeros(len(year), dtype=bool)
        else:
            base = np.asarray([0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334], np.int32)
            doy = base[month - 1] + day
            if cal == "standard":
                leap = (year % 4 == 0) & ((year % 100 != 0) | (year % 400 == 0))
            elif cal == "all_leap":
                leap = np.ones(len(year), dtype=bool)
            else:  # noleap
                leap = np.zeros(len(year), dtype=bool)
            doy = doy + (leap & (month > 2)).astype(np.int32)
        return cls(month=month, day=day, dayofyear=doy.astype(np.int32), year=year, is_leap_year=leap)


@dataclasses.dataclass(frozen=True)
class PaddedGroups:
    """Fixed-shape encoding of a ragged grouping of time steps.

    ``indices[g, j]`` is the time index of the ``j``-th member of group ``g``;
    entries with ``mask[g, j] == False`` are padding (index 0).  ``counts[g]``
    is the true member count.
    """

    indices: np.ndarray  # (G, Lmax) int32
    mask: np.ndarray  # (G, Lmax) bool
    counts: np.ndarray  # (G,) int32
    keys: np.ndarray  # (G,) group key (e.g. month number)
    labels: np.ndarray | None = None  # (n,) int32 group id per time step, if a partition

    @property
    def n_groups(self) -> int:
        return self.indices.shape[0]

    def __hash__(self) -> int:
        return hash((self.indices.tobytes(), self.mask.tobytes(), self.keys.tobytes()))

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, PaddedGroups):
            return NotImplemented
        return (
            np.array_equal(self.indices, other.indices)
            and np.array_equal(self.mask, other.mask)
            and np.array_equal(self.keys, other.keys)
        )

    @classmethod
    def from_labels(cls, labels: np.ndarray, keys: np.ndarray) -> "PaddedGroups":
        """Build from a per-timestep integer label array (a partition).
        Member order within a group is ascending time order, as
        ``pandas.groupby`` keeps it."""
        labels = np.asarray(labels)
        n_groups = len(keys)
        counts = np.bincount(labels, minlength=n_groups).astype(np.int32)
        lmax = max(int(counts.max()), 1)
        indices = np.zeros((n_groups, lmax), dtype=np.int32)
        mask = np.zeros((n_groups, lmax), dtype=bool)
        for g in range(n_groups):
            members = np.nonzero(labels == g)[0]
            indices[g, : len(members)] = members
            mask[g, : len(members)] = True
        return cls(
            indices=indices,
            mask=mask,
            counts=counts,
            keys=np.asarray(keys),
            labels=labels.astype(np.int32),
        )
