"""Carry fitted BCSD state between the JAX package and the port.

The JAX package's single-cell wrapper keeps its fitted state as numpy
arrays (``jax.tree_util.tree_map(np.asarray, state)``, ``bcsd.py:704``);
the grid runner's state is a ``BcsdState`` of device arrays with the same
three fields ``(pp, vals, aux)`` in the same flat layout; its lazy
(streaming) state is a ``BcsdLazyState`` ``(y, aux)``.  These helpers move
either state into the port's :class:`~.models.bcsd.BcsdState` /
:class:`~.models.bcsd.BcsdLazyState` and back, so a state fitted by one
package can be used by the other's predict.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.bcsd import BcsdLazyState, BcsdState

__all__ = [
    "bcsd_state_from_jax",
    "bcsd_state_to_numpy",
    "bcsd_lazy_state_from_jax",
    "bcsd_lazy_state_to_numpy",
]


def bcsd_state_from_jax(pp, vals, aux, device="cpu", dtype=None) -> BcsdState:
    """Numpy ``(pp, vals, aux)`` -> the port's ``BcsdState`` on ``device``
    (in ``dtype``, default the arrays' own)."""
    dev = torch.device(device)
    return BcsdState(
        *(torch.tensor(np.asarray(a), dtype=dtype, device=dev) for a in (pp, vals, aux))
    )


def bcsd_state_to_numpy(state: BcsdState):
    """The port's ``BcsdState`` -> numpy ``(pp, vals, aux)``."""
    return tuple(t.detach().cpu().numpy() for t in state)


def bcsd_lazy_state_from_jax(y, aux, device="cpu", dtype=None) -> BcsdLazyState:
    """Numpy ``(y, aux)`` of a JAX ``BcsdLazyState`` -> the port's
    ``BcsdLazyState`` on ``device`` (in ``dtype``, default the arrays' own)."""
    dev = torch.device(device)
    return BcsdLazyState(*(torch.tensor(np.asarray(a), dtype=dtype, device=dev) for a in (y, aux)))


def bcsd_lazy_state_to_numpy(state: BcsdLazyState):
    """The port's ``BcsdLazyState`` -> numpy ``(y, aux)``."""
    return tuple(t.detach().cpu().numpy() for t in state)
