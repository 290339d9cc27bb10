"""Tensor operations of the port: ordered keys, CDFs, gathers, table
interpolation (K6), k-nearest analogs, ranks, regression and rolling
means.  Exports the names of ``skdownscale_tpu.ops`` but
``interp_sortmerge``, the TPU's gather-free lowering of ``interp_rows``
(K6 takes its place).  As there, ``ops.interp`` and ``ops.knn`` name the
functions; import the modules as ``skdownscale_tpu_torch.ops.interp``
through ``importlib`` or ``from skdownscale_tpu_torch.ops.interp import``."""

from .cdf import Cdf, calc_extrapolated_cdf, plotting_positions
from .gather import take_rows
from .interp import (
    interp,
    interp_padded,
    interp_ramp,
    interp_rows,
    interp_rows_multi,
    pad_table,
)
from .knn import knn
from .ranks import self_quantiles
from .regression import (
    linreg_fit,
    linreg_predict,
    logistic_fit,
    logistic_predict_proba,
    ols_1d,
    ols_predict_1d,
    rmse,
)
from .rolling import (
    rolling_mean,
    rolling_mean_std,
    rolling_std,
    rolling_sum_count,
)

__all__ = [
    "Cdf",
    "calc_extrapolated_cdf",
    "plotting_positions",
    "take_rows",
    "interp",
    "interp_padded",
    "interp_ramp",
    "interp_rows",
    "interp_rows_multi",
    "pad_table",
    "knn",
    "self_quantiles",
    "linreg_fit",
    "linreg_predict",
    "logistic_fit",
    "logistic_predict_proba",
    "ols_1d",
    "ols_predict_1d",
    "rmse",
    "rolling_mean",
    "rolling_mean_std",
    "rolling_std",
    "rolling_sum_count",
]
