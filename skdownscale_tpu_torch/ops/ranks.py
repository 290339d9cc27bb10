"""Rank-based self-quantiles.

Port of ``skdownscale_tpu/ops/ranks.py``.  ``CunnaneTransformer.fit_transform(x)``
(transform a series through the CDF fit on *itself*) is, for self-queries,
exactly each value's rank plotting position with ties resolved to the LAST
tied slot (np.interp's tie semantics): one stable sort with positions, a
reverse running minimum and one inverse-permutation scatter, no table
interp.
"""

from __future__ import annotations

import torch

__all__ = ["self_quantiles"]


def self_quantiles(x, pp):
    """``np.interp(x, np.sort(x), pp)`` computed exactly, per row.

    ``x``: (..., n) (may contain +inf padding: pads receive values that
    callers mask out); ``pp``: (n,) or broadcastable (..., n) non-decreasing
    plotting positions assigned to sorted order.  Returns the per-element
    plotting position (..., n) in element order; tied values all take the
    last tied slot's pp."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    rows = x.reshape(-1, n)
    sv, spos = torch.sort(rows, dim=1, stable=True)
    pp_rows = torch.broadcast_to(pp, (*lead, n)).reshape(-1, n)
    # the last slot of each equal-value run carries the run's pp; pp is
    # non-decreasing, so a reverse running minimum of run-end pps spreads
    # each run's final pp across the run
    run_end = torch.ones_like(sv, dtype=torch.bool)
    run_end[:, :-1] = sv[:, 1:] != sv[:, :-1]
    key = torch.where(run_end, pp_rows, float("inf"))
    pp_adj = torch.flip(torch.cummin(torch.flip(key, [1]), dim=1).values, [1])
    out = torch.empty_like(pp_adj)
    out.scatter_(1, spos, pp_adj)  # inverse permutation
    return out.reshape(*lead, n)
