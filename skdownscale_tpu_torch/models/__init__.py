"""Estimators and their batched (cells, time) implementations; MBCn
(``mbc.py``) has its own grid runner, ``mbcn_grid``.  Exports the names of
``skdownscale_tpu.models``."""

from . import batched
from .arrm import PiecewiseLinearRegression
from .bcsd import BcsdPrecipitation, BcsdTemperature
from .gard import AnalogRegression, PureAnalog, PureRegression
from .groupers import DAY_GROUPER, MONTH_GROUPER, PaddedDOYGrouper
from .grouping import GroupedRegressor
from .mbc import MBCn
from .quantile import (
    CunnaneTransformer,
    EquidistantCdfMatcher,
    QuantileMapper,
    QuantileMappingReressor,
    TrendAwareQuantileMappingRegressor,
)
from .trend import LinearTrendTransformer
from .zscore import ZScoreRegressor

__all__ = [
    "batched",
    "MBCn",
    "PiecewiseLinearRegression",
    "BcsdPrecipitation",
    "BcsdTemperature",
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
