"""Cell-axis padding for an even split across devices.

Host copy of ``pad_to_multiple`` from ``skdownscale_tpu/parallel/mesh.py``.
The port runs on one device; cell sharding over several (``cell_mesh``,
``cell_sharding``, ``shard_cells``) waits for the multi-device layer
(ROADMAP Queue 1 A item 5).  Nothing here touches torch.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pad_to_multiple"]


def pad_to_multiple(arr, multiple: int, axis: int = 0, fill=np.nan):
    """Pad ``axis`` up to a multiple (sharding needs even divisibility);
    returns the padded array and the original length."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, rem)
    return np.pad(arr, widths, constant_values=fill), n
