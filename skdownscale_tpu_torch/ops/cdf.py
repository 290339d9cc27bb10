"""CDF construction with synthetic-endpoint extrapolation.

Port of ``skdownscale_tpu/ops/cdf.py``: the reference's
``plotting_positions`` (``pointwise_models/quantile.py:23-43``) and
``QuantileMappingReressor._calc_extrapolated_cdf`` (``quantile.py:312-387``)
as batched PyTorch functions.

A CDF of ``n`` samples is a pair of ``(..., n+2)`` tensors: Cunnane plotting
positions bracketed by two synthetic endpoints whose values depend on the
``extrapolate`` mode (``None``/``'1to1'`` duplicate the end knots;
``'min'``/``'max'``/``'both'`` push the endpoint plotting position to
``-+1e20`` and extrapolate the endpoint *value* from the first/last
``n_endpoints`` knots by OLS).  The plotting positions are the same for
every row, so ``pp`` is an ``expand`` of one vector, never a per-row copy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .regression import ols_1d, ols_predict_1d

SYNTHETIC_MIN = -1e20  # quantile.py:17
SYNTHETIC_MAX = 1e20  # quantile.py:18

_VALID_EXTRAPOLATE = (None, "1to1", "min", "max", "both")

__all__ = ["Cdf", "plotting_positions", "calc_extrapolated_cdf", "SYNTHETIC_MIN", "SYNTHETIC_MAX"]


class Cdf(NamedTuple):
    """Mirror of the reference's ``Cdf`` namedtuple (``quantile.py:20``)."""

    pp: torch.Tensor
    vals: torch.Tensor


def plotting_positions(n: int, alpha: float = 0.4, beta: float = 0.4, dtype=torch.float64, device=None):
    """Cunnane plotting positions, in ``dtype``; port of ``quantile.py:23-43``."""
    return (torch.arange(1, n + 1, dtype=dtype, device=device) - alpha) / (n + 1.0 - alpha - beta)


def calc_extrapolated_cdf(
    data,
    *,
    sort: bool = True,
    extrapolate: str | None = None,
    n_endpoints: int = 10,
    pp_min: float = SYNTHETIC_MIN,
    pp_max: float = SYNTHETIC_MAX,
) -> Cdf:
    """Build an extrapolated CDF from ``(..., n)`` data (leading batch dims
    preserved; the pp vector is expanded over them).  Semantics of
    ``quantile.py:312-387``.  Returns ``Cdf`` of two ``(..., n+2)`` tensors."""
    if extrapolate not in _VALID_EXTRAPOLATE:
        raise ValueError(f"unknown value for extrapolate: {extrapolate}")
    n = data.shape[-1]
    if sort:
        data = torch.sort(data, dim=-1, stable=True).values

    pp_core = plotting_positions(n, dtype=data.dtype, device=data.device)

    def const(v):
        return torch.full((1,), v, dtype=data.dtype, device=data.device)

    first = const(pp_min) if extrapolate in ("min", "both") else pp_core[:1]
    last = const(pp_max) if extrapolate in ("max", "both") else pp_core[-1:]
    pp = torch.cat([first, pp_core, last]).expand(*data.shape[:-1], n + 2)

    v_first = data[..., 0]
    v_last = data[..., -1]
    if extrapolate in ("min", "both"):
        # OLS of vals ~ pp over the first n_endpoints knots, evaluated at pp[0]
        slope, intercept = ols_1d(pp_core[:n_endpoints], data[..., :n_endpoints])
        v_first = ols_predict_1d(slope, intercept, first[0])
    if extrapolate in ("max", "both"):
        slope, intercept = ols_1d(pp_core[-n_endpoints:], data[..., -n_endpoints:])
        v_last = ols_predict_1d(slope, intercept, last[0])
    vals = torch.cat([v_first[..., None], data, v_last[..., None]], dim=-1)
    return Cdf(pp, vals)
