"""Migration shim: the reference's import path, one package swap away.

The reference is used as ``from skdownscale.pointwise_models import ...``;
this module keeps that path for the port, as
``skdownscale_tpu/pointwise_models.py`` does for the JAX package::

    from skdownscale_tpu_torch.pointwise_models import BcsdTemperature, PointWiseDownscaler
"""

from . import (
    DAY_GROUPER,
    MONTH_GROUPER,
    AnalogRegression,
    BcsdPrecipitation,
    BcsdTemperature,
    CunnaneTransformer,
    EquidistantCdfMatcher,
    GroupedRegressor,
    LinearTrendTransformer,
    PaddedDOYGrouper,
    PiecewiseLinearRegression,
    PointWiseDownscaler,
    PureAnalog,
    PureRegression,
    QuantileMapper,
    QuantileMappingReressor,
    TrendAwareQuantileMappingRegressor,
    ZScoreRegressor,
)

__all__ = [
    "PiecewiseLinearRegression",
    "BcsdPrecipitation",
    "BcsdTemperature",
    "PointWiseDownscaler",
    "AnalogRegression",
    "PureAnalog",
    "PureRegression",
    "DAY_GROUPER",
    "MONTH_GROUPER",
    "PaddedDOYGrouper",
    "GroupedRegressor",
    "CunnaneTransformer",
    "EquidistantCdfMatcher",
    "QuantileMapper",
    "QuantileMappingReressor",
    "TrendAwareQuantileMappingRegressor",
    "LinearTrendTransformer",
    "ZScoreRegressor",
]
