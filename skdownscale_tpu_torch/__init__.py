"""scikit-downscale on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``skdownscale_tpu`` that keeps its sklearn-style
API.  This package imports torch and never jax.  Ported so far: the monthly
BCSD grid path (``BcsdTemperature``, ``BcsdPrecipitation`` through
``PointWiseDownscaler``), with hand-written CUDA kernels for its segment
count-sort and rank-map (``kernels/``, sources in ``csrc/``).

Float32 matrix products run in full float32: the JAX package ran them at
``Precision.HIGHEST`` (``bcsd.py:209-214``), so TF32 is switched off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import xlite  # noqa: E402
from .models.bcsd import BcsdPrecipitation, BcsdTemperature  # noqa: E402
from .pointwise import PointWiseDownscaler  # noqa: E402

__all__ = ["BcsdTemperature", "BcsdPrecipitation", "PointWiseDownscaler", "xlite"]
