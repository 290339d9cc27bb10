"""Grouped-estimator wrapper and the index-flavoured DOY grouper.

Host copy of ``skdownscale_tpu/models/grouping.py``, mirroring the
reference's ``pointwise_models/grouping.py``: ``GroupedRegressor`` fits one
estimator per group of the fit index and scatters the per-group
predictions back.  It is host glue over any estimator: each inner
estimator of this package runs on its own single-cell device.  Nothing
here touches torch.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..utils.timeindex import TimeIndex, doy_band_groups

__all__ = ["GroupedRegressor", "PaddedDOYGrouper"]


class GroupedRegressor:
    """API of ``grouping.py:12-103``.

    Parameters
    ----------
    estimator : type
        Estimator class fit to each group.
    fit_grouper : type
        Grouper class called as ``fit_grouper(index, **kwargs)`` exposing
        ``.groups`` (dict key -> row indices), e.g. :class:`PaddedDOYGrouper`.
    predict_grouper : callable / str / pd.Grouper
        Passed to ``X.groupby`` at predict time.
    """

    def __init__(
        self,
        estimator: Any,
        fit_grouper: Any,
        predict_grouper: Any,
        estimator_kwargs: dict[str, Any] | None = None,
        fit_grouper_kwargs: dict[str, Any] | None = None,
        predict_grouper_kwargs: dict[str, Any] | None = None,
    ):
        self.estimator = estimator
        self.estimator_kwargs = estimator_kwargs
        self.fit_grouper = fit_grouper
        self.fit_grouper_kwargs = fit_grouper_kwargs
        self.predict_grouper = predict_grouper
        self.predict_grouper_kwargs = predict_grouper_kwargs

    def fit(self, X, y, **fit_kwargs):
        fg_kwargs = self.fit_grouper_kwargs or {}
        x_groups = self.fit_grouper(X.index, **fg_kwargs).groups
        y_groups = self.fit_grouper(y.index, **fg_kwargs).groups

        self.targets_ = list(y.keys())
        est_kwargs = self.estimator_kwargs or {}
        self.estimators_ = {key: self.estimator(**est_kwargs) for key in x_groups}

        for x_key, x_inds in x_groups.items():
            y_inds = y_groups[x_key]
            self.estimators_[x_key].fit(X.iloc[x_inds], y.iloc[y_inds], **fit_kwargs)
        return self

    def predict(self, X):
        pg_kwargs = self.predict_grouper_kwargs or {}
        grouper = X.groupby(self.predict_grouper, **pg_kwargs)

        result = np.empty((len(X), len(self.targets_)))
        for key, inds in grouper.indices.items():
            result[inds, ...] = np.asarray(self.estimators_[key].predict(X.iloc[inds])).reshape(
                len(inds), -1
            )
        return result


class PaddedDOYGrouper:
    """Index-flavoured grouper (``grouping.py:106-138``): groups a
    DatetimeIndex by day-of-year with a +/- ``window`` circular band."""

    def __init__(self, index, window: int):
        self.index = index
        self.window = window
        pg = doy_band_groups(TimeIndex.from_any(index), window)
        self._groups = {
            int(k): pg.indices[g, : pg.counts[g]].astype(np.intp)
            for g, k in enumerate(pg.keys)
        }

    @property
    def groups(self) -> dict:
        """Dict {doy -> row indices}."""
        return self._groups
