"""Row gathering.

Port of ``take_rows`` of ``skdownscale_tpu/ops/gather.py``.  The JAX package
gathers rows on the TPU as blocked one-hot matrix products, a device of the
TPU's gather lowering; here it is one ``torch.gather``.
"""

from __future__ import annotations

import torch

__all__ = ["take_rows"]


def take_rows(data, inds):
    """``data[..., inds, :]``: rows of ``data`` (..., T, P) by ``inds``
    (..., Q) integer -> (..., Q, P); the leading dims of both agree."""
    return torch.gather(data, -2, inds[..., None].expand(*inds.shape, data.shape[-1]))
