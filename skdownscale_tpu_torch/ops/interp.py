"""Batched 1-D linear interpolation on monotone tables.

Port of ``skdownscale_tpu/ops/interp.py``.  ``np.interp`` is the reference's
hottest primitive in its quantile machinery; here every form goes through
the row-batched kernel K6 (:func:`~..kernels.interp.batched_interp`, plain
PyTorch on the CPU), in ``interp_ramp``'s semantics: np.interp with clamped
ends, tied knots resolved to the last tie, the value evaluated from the
nearer knot (stable next to the quantile paths' +-1e20 sentinels), and
*padded tables*: ragged rows padded per :func:`pad_table` (``+inf`` knots,
the last valid ``fp``) interpolate as their unpadded rows.

The JAX package switches its CPU route at ``L = 1024`` from the dense
reduction (``interp_ramp``) to a sort-merge; the port's K6 takes any ``L``
and has no such switch.
"""

from __future__ import annotations

import math

import torch

from ..kernels.interp import batched_interp

__all__ = ["interp", "interp_ramp", "interp_rows", "interp_rows_multi", "interp_padded", "pad_table"]


def _as_rows(t: torch.Tensor, lead: tuple, n: int) -> torch.Tensor:
    """``t`` broadcast to ``(*lead, n)`` as a contiguous 2-D row table: one
    row when ``t`` is the same for every leading index (a vector, or an
    ``expand`` of one), else ``prod(lead)`` rows."""
    t = t.broadcast_to((*lead, n))
    if all(s == 0 or d == 1 for s, d in zip(t.stride()[:-1], t.shape[:-1])):
        return t[(0,) * len(lead)].reshape(1, n).contiguous()
    return t.reshape(-1, n).contiguous()


def interp_rows(xp, fp, q):
    """Row-matched batched interp: ``out[..., b, i] = interp(q[..., b, i],
    xp[..., b, :], fp[..., b, :])`` over arbitrary leading dims (the
    leading dims of ``xp``, ``fp`` and ``q`` broadcast).  Tables must be
    monotone rows, ragged rows padded per :func:`pad_table`.  A table or
    query set shared by every row (a broadcast vector) is passed to K6
    once, not copied per row."""
    lead = torch.broadcast_shapes(xp.shape[:-1], fp.shape[:-1], q.shape[:-1])
    L, Q = xp.shape[-1], q.shape[-1]
    if math.prod(lead) == 0:
        return torch.empty((*lead, Q), dtype=q.dtype, device=q.device)
    out = batched_interp(_as_rows(xp, lead, L), _as_rows(fp, lead, L), _as_rows(q, lead, Q))
    return out.reshape(*lead, Q)


def interp_rows_multi(xp, fps, q):
    """Like :func:`interp_rows` but mapping the same queries through several
    value tables that share one knot vector."""
    return [interp_rows(xp, fp, q) for fp in fps]


def interp_ramp(x, xp, fp):
    """``np.interp`` of ``x`` (any shape) on one table ``xp``, ``fp`` (L,),
    clamped ends, in the semantics K6 follows (ties to the last tied knot,
    the value from the nearer knot, ``+inf``-padded tails clamp to the last
    valid knot, F7): :func:`interp` without fill values."""
    return interp(x, xp, fp)


def interp(x, xp, fp, left=None, right=None):
    """``np.interp`` of ``x`` (any shape) on one table ``xp``, ``fp`` (L,),
    with optional ``left`` / ``right`` fill values (default: clamp to the
    end values of ``fp``)."""
    res = interp_rows(xp, fp, x.reshape(-1)).reshape(x.shape)
    if left is not None:
        res = torch.where(x < xp[0], left, res)
    if right is not None:
        res = torch.where(x > xp[-1], right, res)
    return res


def pad_table(xp, fp, valid):
    """Prepare a ragged table for :func:`interp_padded`.

    Invalid (padding) entries must be at the *end*.  Sets padded ``xp`` to
    ``+inf`` (keeps it sorted) and padded ``fp`` to the last *valid*
    ``fp``, so ``fp`` stays monotone and the slope into the pad region is
    exactly 0: queries beyond the last valid knot clamp to the last valid
    ``fp``."""
    xp = torch.where(valid, xp, float("inf"))
    f_last = torch.where(valid, fp, float("-inf")).amax(dim=-1, keepdim=True)
    fp = torch.where(valid, fp, f_last)
    return xp, fp


def interp_padded(x, xp, fp, n_valid, left=None, right=None):
    """``np.interp(x, xp[:n_valid], fp[:n_valid], left, right)`` with a
    fixed-shape padded table in :func:`pad_table` form."""
    res = interp(x, xp, fp)  # +inf pads clamp to the last valid knot
    if right is not None:
        res = torch.where(x > xp[n_valid - 1], right, res)
    if left is not None:
        res = torch.where(x < xp[0], left, res)
    return res
