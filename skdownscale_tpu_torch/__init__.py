"""scikit-downscale on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``skdownscale_tpu`` that keeps its sklearn-style
API.  This package imports torch and never jax.  Ported so far: BCSD
(``BcsdTemperature``, ``BcsdPrecipitation``), monthly and daily
(``time_grouper="daily_nasa-nex"``), dense and streaming, and the
quantile-mapping family (``CunnaneTransformer``, ``QuantileMapper``,
``QuantileMappingReressor``, ``EquidistantCdfMatcher``,
``TrendAwareQuantileMappingRegressor``, ``LinearTrendTransformer``), the
GARD analog family (``PureAnalog``, ``AnalogRegression``,
``PureRegression``), day-of-year z-scores (``ZScoreRegressor``) and ARRM
(``PiecewiseLinearRegression``), through ``PointWiseDownscaler`` (any other
sklearn-style estimator takes its per-cell loop) and the single-cell API,
``GroupedRegressor``, multivariate MBCn (``MBCn``,
``models.mbc.mbcn_grid``) and the pooled models of ``global_models``
(``GlobalLinearRegressor``, ``GlobalQuantileMapper``,
``GlobalDownscaler``) on one device, the store -> device -> store pipeline
(``parallel.pipeline``), checkpoints, metrics, disaggregation and
profiling (``utils``) and the BCSD command line (``cli``), with
hand-written CUDA kernels for the segment count-sort, rank-map, sliding
sorted window, batched table interpolation, the fused analog selection and
statistics, and the row sort with positions and unsort (K9) (``kernels/``,
sources in ``csrc/``).

The single-cell API runs on the card unless the caller sets
``SingleCellEstimator.single_cell_device = torch.device("cpu")``
(``models/base.py``); ``PointWiseDownscaler`` takes its ``device``.

Float32 matrix products run in full float32: the JAX package ran them at
``Precision.HIGHEST`` (``bcsd.py:209-214``, the kNN distances of
``ops/knn.py``), so TF32 is switched off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import global_models, xlite  # noqa: E402
from .global_models import (  # noqa: E402
    GlobalDownscaler,
    GlobalLinearRegressor,
    GlobalQuantileMapper,
)
from .models.arrm import PiecewiseLinearRegression  # noqa: E402
from .models.bcsd import BcsdPrecipitation, BcsdTemperature  # noqa: E402
from .models.gard import AnalogRegression, PureAnalog, PureRegression  # noqa: E402
from .models.groupers import DAY_GROUPER, MONTH_GROUPER, PaddedDOYGrouper  # noqa: E402
from .models.grouping import GroupedRegressor  # noqa: E402
from .models.mbc import MBCn  # noqa: E402
from .models.quantile import (  # noqa: E402
    CunnaneTransformer,
    EquidistantCdfMatcher,
    QuantileMapper,
    QuantileMappingReressor,
    TrendAwareQuantileMappingRegressor,
)
from .models.trend import LinearTrendTransformer  # noqa: E402
from .models.zscore import ZScoreRegressor  # noqa: E402
from .pointwise import PointWiseDownscaler  # noqa: E402

__all__ = [
    "BcsdTemperature",
    "BcsdPrecipitation",
    "PointWiseDownscaler",
    "DAY_GROUPER",
    "MONTH_GROUPER",
    "PaddedDOYGrouper",
    "CunnaneTransformer",
    "EquidistantCdfMatcher",
    "QuantileMapper",
    "QuantileMappingReressor",
    "TrendAwareQuantileMappingRegressor",
    "LinearTrendTransformer",
    "PureAnalog",
    "AnalogRegression",
    "PureRegression",
    "MBCn",
    "ZScoreRegressor",
    "PiecewiseLinearRegression",
    "GroupedRegressor",
    "global_models",
    "GlobalDownscaler",
    "GlobalLinearRegressor",
    "GlobalQuantileMapper",
    "xlite",
]
