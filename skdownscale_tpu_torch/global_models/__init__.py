"""Global (pooled-across-space) downscaling models on one device.

Port of ``skdownscale_tpu/global_models``: pooled fits are reductions
across the cell axis of a grid (a pooled least-squares problem, one pooled
quantile ladder), where the pointwise zoo fits each cell alone.  The
sharded forms wait for the multi-device layer (ROADMAP Queue 1 A item 5).
"""

from .downscaler import GlobalDownscaler
from .linear import GlobalLinearRegressor, global_linear_fit, global_linear_predict
from .quantile import GlobalQuantileMapper, pooled_quantile_table

__all__ = [
    "GlobalDownscaler",
    "GlobalLinearRegressor",
    "GlobalQuantileMapper",
    "global_linear_fit",
    "global_linear_predict",
    "pooled_quantile_table",
]
