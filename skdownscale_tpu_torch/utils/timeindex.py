"""Host-side calendar features for a time axis.

Host copy of ``skdownscale_tpu/utils/timeindex.py`` (``TimeIndex``,
``PaddedGroups`` and the month, day-of-month, padded day-of-year and
day-of-year band group builders): group structure is built once on the
host as plain numpy arrays and uploaded to the device as index tensors by
the callers.  Nothing in this module touches torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = [
    "TimeIndex",
    "PaddedGroups",
    "month_groups",
    "day_groups",
    "padded_doy_groups",
    "doy_band_groups",
]


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
    def from_any(cls, index) -> "TimeIndex":
        if isinstance(index, TimeIndex):
            return index
        return cls.from_pandas(index)

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

    @classmethod
    def range_daily(cls, n: int, start_year: int = 1950, calendar: str = "noleap") -> "TimeIndex":
        """Sequential daily index of length ``n`` from Jan 1 of ``start_year``
        under a climate calendar (see :meth:`from_components`)."""
        cal = {"365_day": "noleap", "366_day": "all_leap"}.get(calendar, calendar)
        if cal == "360_day":
            month_days = lambda y: np.full(12, 30, np.int32)
        else:
            base = np.asarray([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], np.int32)

            def month_days(y):
                md = base.copy()
                if cal == "all_leap" or (
                    cal == "standard" and (y % 4 == 0 and (y % 100 != 0 or y % 400 == 0))
                ):
                    md[1] = 29
                return md

        years, months, days = [], [], []
        y = int(start_year)
        remaining = int(n)
        while remaining > 0:
            md = month_days(y)
            for m in range(12):
                k = min(int(md[m]), remaining)
                if k <= 0:
                    break
                years.append(np.full(k, y, np.int32))
                months.append(np.full(k, m + 1, np.int32))
                days.append(np.arange(1, k + 1, dtype=np.int32))
                remaining -= k
                if remaining == 0:
                    break
            y += 1
        return cls.from_components(
            np.concatenate(years), np.concatenate(months), np.concatenate(days), calendar=cal
        )

    @property
    def max_dayofyear(self) -> int:
        return int(self.dayofyear.max())


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
    keys: np.ndarray  # (G,) group key (e.g. month number, day-of-year)
    labels: np.ndarray | None = None  # (n,) int32 group id per time step, if a partition

    @property
    def n_groups(self) -> int:
        return self.indices.shape[0]

    @property
    def max_len(self) -> int:
        return self.indices.shape[1]

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

    @classmethod
    def from_member_lists(cls, members: list[np.ndarray], keys: np.ndarray) -> "PaddedGroups":
        """Build from explicit (possibly overlapping) member index lists."""
        counts = np.array([len(m) for m in members], dtype=np.int32)
        lmax = max(int(counts.max()), 1)
        indices = np.zeros((len(members), lmax), dtype=np.int32)
        mask = np.zeros((len(members), lmax), dtype=bool)
        for g, m in enumerate(members):
            indices[g, : len(m)] = m
            mask[g, : len(m)] = True
        return cls(indices=indices, mask=mask, counts=counts, keys=np.asarray(keys), labels=None)


# ----------------------------------------------------------------------
# group builders mirroring the reference's groupers
# ----------------------------------------------------------------------


def _key_partition(keys: np.ndarray) -> PaddedGroups:
    """Partition by an integer key per time step, groups in ascending key
    order (a pandas groupby on that key)."""
    present, labels = np.unique(keys, return_inverse=True)
    return PaddedGroups.from_labels(labels.astype(np.int32), present.astype(np.int32))


def month_groups(ti: TimeIndex) -> PaddedGroups:
    """Partition by calendar month: the reference's ``MONTH_GROUPER``
    (``groupers.py:11-12``) used as a pandas groupby key."""
    return _key_partition(ti.month)


def day_groups(ti: TimeIndex) -> PaddedGroups:
    """Partition by day of month: the reference's ``DAY_GROUPER``
    (``groupers.py:15-16``)."""
    return _key_partition(ti.day)


def _wrapped_window_days(n_days: int, doy: int, offset: int) -> np.ndarray:
    """Day-of-year values within +/- ``offset`` of ``doy`` on a circular
    ``n_days``-day calendar (semantics of ``groupers.py:37-64``)."""
    window = np.arange(doy - offset, doy + offset + 1)
    return ((window - 1) % n_days) + 1


def padded_doy_groups(ti: TimeIndex, offset: int = 15) -> PaddedGroups:
    """Overlapping day-of-year groups with a +/- ``offset``-day circular pad.

    Mirrors the iterator-flavoured ``PaddedDOYGrouper`` (``groupers.py:19-82``):
    one group per day-of-year 1..366; rows in leap years are matched against a
    366-day circular calendar and rows in non-leap years against a 365-day
    calendar; each group lists leap-year rows first, then non-leap rows.
    """
    leap_rows = np.nonzero(ti.is_leap_year)[0]
    noleap_rows = np.nonzero(~ti.is_leap_year)[0]
    doy = ti.dayofyear
    members: list[np.ndarray] = []
    keys = np.arange(1, 367, dtype=np.int32)
    for d in keys:
        days_leap = set(_wrapped_window_days(366, int(d), offset).tolist())
        days_noleap = set(_wrapped_window_days(365, int(d), offset).tolist())
        sel_leap = leap_rows[np.isin(doy[leap_rows], list(days_leap))]
        sel_noleap = noleap_rows[np.isin(doy[noleap_rows], list(days_noleap))]
        members.append(np.concatenate([sel_leap, sel_noleap]))
    return PaddedGroups.from_member_lists(members, keys)


def doy_band_groups(ti: TimeIndex, window: int) -> PaddedGroups:
    """Index-flavoured ``PaddedDOYGrouper`` (``grouping.py:106-138``): one
    group per observed day-of-year 1..max(doy), membership = rows whose doy is
    within a +/- ``window`` circular band on a max(doy)-day calendar."""
    doy = ti.dayofyear
    n = int(doy.max())
    members = []
    keys = np.arange(1, n + 1, dtype=np.int32)
    for d in keys:
        band = (np.arange(d - 1 - window, d + window) % n) + 1
        members.append(np.nonzero(np.isin(doy, band))[0])
    return PaddedGroups.from_member_lists(members, keys)
