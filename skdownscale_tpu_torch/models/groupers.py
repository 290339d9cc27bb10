"""Time groupers (public API surface).

Host copy of ``skdownscale_tpu/models/groupers.py``, mirroring the
reference's ``pointwise_models/groupers.py``: the ``MONTH_GROUPER`` /
``DAY_GROUPER`` callables and the iterator-flavoured ``PaddedDOYGrouper``
yielding ``(day_of_year, sub-DataFrame)`` pairs with a +/- ``offset``-day
circular pad, handling leap and non-leap calendars separately.  The grid
path consumes the same membership structure through
``utils.timeindex.padded_doy_groups``.  Nothing here touches torch.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..utils.timeindex import _wrapped_window_days

__all__ = ["MONTH_GROUPER", "DAY_GROUPER", "PaddedDOYGrouper", "SkdownscaleGroupGeneratorBase"]


class SkdownscaleGroupGeneratorBase:
    pass


def MONTH_GROUPER(x):
    """``groupers.py:11-12``."""
    return x.month


def DAY_GROUPER(x):
    """``groupers.py:15-16``."""
    return x.day


class PaddedDOYGrouper(SkdownscaleGroupGeneratorBase):
    """Iterator over 366 day-of-year groups with a circular +/- ``offset`` pad
    (semantics of ``groupers.py:19-82``): leap-year rows are matched on a
    366-day calendar, non-leap rows on a 365-day calendar; each yielded frame
    lists leap-year rows first."""

    def __init__(self, df, offset: int = 15):
        self.n = 1
        self.df = df
        self.max = 366
        idx = df.index
        self.leap = "leap" if ((idx.month == 2) & (idx.day == 29)).any() else "noleap"
        self.df_leap = df[idx.is_leap_year]
        self.df_noleap = df[~idx.is_leap_year]
        self.offset = offset

    def __iter__(self):
        self.n = 1
        return self

    def __next__(self):
        import pandas as pd

        if self.n > self.max:
            raise StopIteration
        doy = self.n
        days_leap = _wrapped_window_days(366, doy, self.offset)
        days_noleap = _wrapped_window_days(365, doy, self.offset)

        if len(set(days_leap.tolist())) != 2 * self.offset + 1 and self.leap == "noleap":
            warnings.warn("leap days not included, day groups in leap years missing leap days")

        result = pd.concat(
            [
                self.df_leap[self.df_leap.index.dayofyear.isin(days_leap)],
                self.df_noleap[self.df_noleap.index.dayofyear.isin(days_noleap)],
            ]
        )
        self.n += 1
        return doy, result

    def mean(self):
        """366-row day-of-year climatology (``groupers.py:84-89``)."""
        import pandas as pd

        arr_means = np.full((self.max, 1), np.inf)
        for key, group in self:
            arr_means[key - 1] = group.mean().values[0]
        return pd.DataFrame(arr_means, index=np.arange(1, self.max + 1))
