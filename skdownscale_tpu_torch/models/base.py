"""sklearn-compatible base plumbing for the single-cell estimator API.

Host copy of ``SingleCellEstimator``, ``asarray_2d`` and ``get_index`` from
``skdownscale_tpu/models/base.py``, mirroring ``TimeSynchronousDownscaler``
of the reference (``pointwise_models/base.py:12-136``): pandas
DatetimeIndexes are preserved, missing indexes are fabricated with a
warning, ``n_features_in_`` is tracked, and fitted state lives in
trailing-underscore attributes listed in ``_fit_attributes`` (clone-safe:
``__init__`` only stores params).
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["NotFittedError", "SingleCellEstimator", "asarray_2d", "get_index"]


try:  # subclass sklearn's so `except sklearn.exceptions.NotFittedError` works
    from sklearn.exceptions import NotFittedError as _SklearnNotFittedError

    class NotFittedError(_SklearnNotFittedError):
        """Raised when predict/transform is called before fit."""

except ImportError:  # pragma: no cover - sklearn absent

    class NotFittedError(ValueError, AttributeError):
        """Mirror of sklearn's NotFittedError (subclassing the same bases)."""


def _is_pandas(obj) -> bool:
    return hasattr(obj, "iloc")


def asarray_2d(X) -> np.ndarray:
    """Coerce Series/DataFrame/1-D/2-D array to a float (n, k) ndarray
    (semantics of ``utils.py:28-43`` ``ensure_samples_features``)."""
    if hasattr(X, "toarray") and hasattr(X, "tocsr"):  # scipy sparse duck-type
        raise TypeError(
            f"sparse input is not supported by {type(X).__name__}; densify with "
            ".toarray() first"
        )
    if _is_pandas(X):
        X = X.to_frame() if X.ndim == 1 else X
        raw = X.to_numpy()
    else:
        raw = np.asarray(X)
        if raw.ndim == 1:
            raw = raw.reshape(-1, 1)
    if np.iscomplexobj(raw):
        raise ValueError("Complex data not supported")
    arr = np.asarray(raw, dtype=float)
    if arr.ndim != 2:
        raise ValueError(f"Expected 1-D or 2-D input, got {arr.ndim}-D")
    if arr.shape[0] == 0:
        raise ValueError(
            f"Found array with 0 sample(s) (shape={arr.shape}) while a minimum "
            "of 1 is required."
        )
    if arr.shape[1] == 0:
        raise ValueError(
            f"Found array with 0 feature(s) (shape={arr.shape}) while a minimum "
            "of 1 is required."
        )
    if not np.all(np.isfinite(arr) | np.isnan(arr)):
        raise ValueError("Input contains infinity or a value too large")
    return arr


def get_index(X, n: int | None = None, freq: str = "MS", warn: bool = True):
    """Return a pandas-like index for X, fabricating a DatetimeIndex starting
    1950 when absent (``base.py:21-24``)."""
    import pandas as pd

    if _is_pandas(X):
        return X.index
    n = n if n is not None else len(X)
    if warn:
        warnings.warn("array does not have a pandas DateTimeIndex, making one up...")
    return pd.date_range(start="1950", periods=n, freq=freq)


class SingleCellEstimator:
    """Minimal sklearn-style estimator base.

    Implements ``get_params``/``set_params`` (so ``sklearn.base.clone``
    works), fit-state introspection via ``_fit_attributes``, and input
    validation helpers.
    """

    _fit_attributes: list = []
    _timestep = "MS"

    @classmethod
    def _get_param_names(cls):
        import inspect

        sig = inspect.signature(cls.__init__)
        return sorted(p for p in sig.parameters if p not in ("self", "args", "kwargs"))

    def get_params(self, deep: bool = True):
        return {name: getattr(self, name) for name in self._get_param_names()}

    def set_params(self, **params):
        valid = self._get_param_names()
        for k, v in params.items():
            if k not in valid:
                raise ValueError(f"Invalid parameter {k!r} for estimator {self!r}")
            setattr(self, k, v)
        return self

    def __repr__(self):
        params = ", ".join(f"{k}={v!r}" for k, v in sorted(self.get_params().items()))
        return f"{type(self).__name__}({params})"

    def _check_is_fitted(self):
        if self._fit_attributes:
            missing = [a for a in self._fit_attributes if not hasattr(self, a)]
            if missing:
                raise NotFittedError(
                    f"This {type(self).__name__} instance is not fitted yet; missing {missing}."
                )
        elif not any(a.endswith("_") and not a.endswith("__") for a in vars(self)):
            raise NotFittedError(f"This {type(self).__name__} instance is not fitted yet.")

    def _check_n_features(self, X, reset: bool):
        n_features = X.shape[1]
        if reset:
            self.n_features_in_ = n_features
        elif getattr(self, "n_features_in_", n_features) != n_features:
            raise ValueError(
                f"X has {n_features} features, but {type(self).__name__} is "
                f"expecting {self.n_features_in_} features as input."
            )

    def _validate_data(self, X, y=None, reset: bool = True):
        """Validate and coerce X (and y).  Pandas objects pass through with
        their index; raw arrays pass through as-is (callers use
        :func:`asarray_2d` for numerics).  Mirrors
        ``TimeSynchronousDownscaler._validate_data`` (``base.py:74-136``).
        """
        if y is None and reset and hasattr(self, "predict"):
            raise ValueError(
                f"This {type(self).__name__} estimator requires y to be passed, "
                "but the target y is None"
            )
        arr = asarray_2d(X)
        was_1d = not _is_pandas(X) and getattr(np.asarray(X), "ndim", 2) == 1
        if (
            was_1d
            and not reset
            and getattr(self, "n_features_in_", arr.shape[1]) != arr.shape[1]
        ):
            raise ValueError(
                f"Expected 2D array, got 1D array instead:\narray={np.asarray(X)!r}.\n"
                "Reshape your data either using array.reshape(-1, 1) if your data "
                "has a single feature or array.reshape(1, -1) if it contains a "
                "single sample."
            )
        self._check_n_features(arr, reset=reset)
        if y is None:
            return X
        if not _is_pandas(y) and getattr(np.asarray(y), "ndim", 1) == 2:
            if np.asarray(y).shape[1] == 1:
                try:
                    from sklearn.exceptions import DataConversionWarning
                except ImportError:  # pragma: no cover
                    DataConversionWarning = UserWarning
                warnings.warn(
                    "A column-vector y was passed when a 1d array was expected. "
                    "Please change the shape of y to (n_samples, ), for example "
                    "using ravel().",
                    DataConversionWarning,
                )
        yarr = asarray_2d(y)
        # the reference's check_X_y rejects non-finite targets (base.py:13-25);
        # NaN is allowed in X (ocean/missing cells) but not in y
        if np.isnan(yarr).any():
            raise ValueError("Input y contains NaN.")
        if len(yarr) != len(arr):
            raise ValueError(
                f"Found input variables with inconsistent numbers of samples: "
                f"[{len(arr)}, {len(yarr)}]"
            )
        if _is_pandas(X) and _is_pandas(y):
            if not np.array_equal(np.asarray(X.index), np.asarray(y.index)):
                raise ValueError("X and y must share an identical index")
        return X, y

    def score(self, X, y, sample_weight=None):
        """Coefficient of determination of the prediction (sklearn's
        ``RegressorMixin.score`` contract, which the reference inherits)."""
        pred = np.asarray(self.predict(X)).reshape(-1)
        yt = asarray_2d(y)[:, 0]
        v = np.isfinite(yt) & np.isfinite(pred)
        ss_res = float(((yt[v] - pred[v]) ** 2).sum())
        ss_tot = float(((yt[v] - yt[v].mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
