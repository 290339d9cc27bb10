"""Group-chunked ("streaming") ragged quantile mapping.

Port of ``skdownscale_tpu/models/streaming.py``.  The dense formulation in
:mod:`.grouped` materializes every fit group's window at once; for the
``'daily_nasa-nex'`` flavor the 366 overlapping +/-15-day DOY windows expand
the training series 27x.  This module runs the same math as a loop over
*transform-group chunks*: each step gathers only its chunk's fit windows and
queries, sorts, maps, and adds into the output, so live device memory is
O(cells * chunk) instead of O(cells * 27 * T).

Two observations make this exact:

* predict-time work factors over the transform partition: each transform
  group maps only through its one matched fit row, so a chunk of transform
  groups needs only its own fit windows (in the daily flavor only 31 of
  the 366 fitted DOY windows are consulted, because the reference groups
  predict by day of month and looks those keys up in the day-of-year table,
  ``bcsd.py:51-53,69-79``);
* the per-group index tables are shared across cells, so they are host
  tables, uploaded once per (tables, device, dtype) and sliced per chunk.

Sorting, Cunnane positions, tail OLS and the intercept-bias reset replicate
:func:`.grouped.grouped_qm_transform` row for row.  The chunk loop is a
Python loop (the JAX package's ``lax.scan``); the output is kept in group
order and restored to time order by one gather at the end.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.regression import ols_1d
from ..utils.timeindex import PaddedGroups
from .grouped import _padded_pp, _rank_bracket_row, _sort_segments, apply_ranked_flat

__all__ = [
    "StreamTables",
    "DeviceStreamTables",
    "build_stream_tables",
    "stream_tables_on",
    "streaming_qm_transform",
]

_INF = float("inf")


def _sort_groups_3d(masked3, Lt: int):
    """Sort the ``Lt``-wide windows of a (..., Gc, Lt) chunk on its flat
    (rows, Gc*Lt) view (:func:`.grouped._sort_segments`: K1, K9 or the plain
    version by ``Lt``)."""
    Gc = masked3.shape[-2]
    return _sort_segments(masked3.reshape(-1, Gc * Lt), Lt).reshape(masked3.shape)


class StreamTables(NamedTuple):
    """Host-built per-chunk tables, stacked on a leading (NC,) chunk axis.

    ``fit_take`` indexes the *source* array (raw series when
    ``source='raw'``; flat sorted state ``vals`` when ``'state'``);
    ``q_take`` indexes the query series; ``hi_pos`` indexes the chunk's
    sorted flat ``(Gc*Lt,)`` table.  Float tables are Cunnane plotting
    positions / tail-window 0-1 weights; masks are prefix masks per group.
    The ``rb_*`` tables are the rank-bracket interp plan of every query
    rank (see :func:`.grouped.rank_bracket_tables`).
    """

    fit_take: np.ndarray  # (NC, Gc*Lt) int32
    fit_mask: np.ndarray  # (NC, Gc, Lt) bool
    lo_w: np.ndarray  # (NC, Gc, ne)
    lo_px: np.ndarray  # (NC, Gc, ne)
    hi_pos: np.ndarray  # (NC, Gc*ne) int32
    hi_w: np.ndarray  # (NC, Gc, ne)
    hi_px: np.ndarray  # (NC, Gc, ne)
    q_take: np.ndarray  # (NC, Gc*Lq) int32
    q_mask: np.ndarray  # (NC, Gc, Lq) bool
    q_pp: np.ndarray  # (NC, Gc, Lq)
    trend_cols: np.ndarray  # (NC, Gc) int32, fit-group column into state trend arrays
    rb_lo: np.ndarray  # (NC, Gc*Lq) int32, flat lower-knot index into (Gc*Lt)
    rb_hi: np.ndarray  # (NC, Gc*Lq) int32, flat upper-knot index
    rb_w0: np.ndarray  # (NC, Gc, Lq) left-anchor lerp weight (q-x0)/dx
    rb_w1: np.ndarray  # (NC, Gc, Lq) right-anchor lerp weight (q-x1)/dx
    rb_right: np.ndarray  # (NC, Gc, Lq) bool, anchor from the nearer knot
    rb_lo_m: np.ndarray  # (NC, Gc, Lq) bool, rank pp below the first fit pp
    rb_hi_m: np.ndarray  # (NC, Gc, Lq) bool, rank pp above the last fit pp


def build_stream_tables(
    fit: PaddedGroups,
    transform: PaddedGroups,
    t2f: np.ndarray,
    *,
    alpha: float = 0.4,
    beta: float = 0.4,
    n_endpoints: int = 10,
    group_chunk: int = 8,
    source: str = "raw",
    dtype=np.float64,
) -> StreamTables:
    """Precompute the chunk tables for one (fit groups, transform partition)
    pair.  ``t2f[g]`` is the fit row consulted by transform group ``g``
    (``_match_keys`` semantics, ``bcsd.py:69-79``).  ``source='raw'`` makes
    ``fit_take`` gather raw time steps (windows sorted in-chunk); ``'state'``
    makes it gather the pre-sorted flat ``(G*Lt,)`` state table."""
    Gt, Lq = transform.indices.shape
    Gf, Lt = fit.indices.shape
    Gc = min(group_chunk, Gt)
    NC = math.ceil(Gt / Gc)
    Gp = NC * Gc  # padded transform-group count
    ne = min(n_endpoints, Lt)

    rows = np.zeros(Gp, np.int64)
    rows[:Gt] = np.asarray(t2f, np.int64)
    live = np.zeros(Gp, bool)
    live[:Gt] = True

    # --- fit side -----------------------------------------------------
    if source == "raw":
        fit_take = fit.indices[rows].astype(np.int32)  # (Gp, Lt)
    elif source == "state":
        fit_take = (rows[:, None] * Lt + np.arange(Lt)[None, :]).astype(np.int32)
    else:
        raise ValueError(f"unknown source {source!r}")
    fit_mask = fit.mask[rows] & live[:, None]
    counts = np.where(live, fit.counts[rows], 0).astype(np.int64)
    pp_all = np.asarray(_padded_pp(fit, alpha, beta), dtype).reshape(Gf, Lt)
    fit_pp = pp_all[rows]

    j = np.arange(ne)
    lo_w = (j[None, :] < counts[:, None]).astype(dtype)
    lo_px = fit_pp[:, :ne]
    start = np.maximum(counts - ne, 0)
    hi_cols = start[:, None] + j[None, :]  # (Gp, ne)
    hi_w = (hi_cols < counts[:, None]).astype(dtype)
    hi_px = np.take_along_axis(fit_pp, hi_cols, axis=1)
    hi_pos = ((np.arange(Gp) % Gc)[:, None] * Lt + hi_cols).astype(np.int32)

    # --- query side -----------------------------------------------------
    q_take = np.zeros((Gp, Lq), np.int32)
    q_take[:Gt] = transform.indices
    q_mask = np.zeros((Gp, Lq), bool)
    q_mask[:Gt] = transform.mask
    q_pp = np.full((Gp, Lq), 0.5, dtype)
    q_pp[:Gt] = np.asarray(_padded_pp(transform, alpha, beta), dtype).reshape(Gt, Lq)

    # --- rank-bracket interp tables: each query rank's bracket in the fit
    # pp grid depends only on (rank, query count, fit count), host data ---
    rb_lo = np.zeros((Gp, Lq), np.int64)
    rb_hi = np.zeros((Gp, Lq), np.int64)
    rb_w0 = np.zeros((Gp, Lq), np.float64)
    rb_w1 = np.zeros((Gp, Lq), np.float64)
    rb_right = np.zeros((Gp, Lq), bool)
    rb_lo_m = np.zeros((Gp, Lq), bool)
    rb_hi_m = np.zeros((Gp, Lq), bool)
    for g in range(Gp):
        nf = int(counts[g])
        if nf <= 0:
            continue
        fg = np.asarray(fit_pp[g, :nf], np.float64)
        qv = np.asarray(q_pp[g], np.float64)
        (
            rb_lo[g],
            rb_hi[g],
            rb_w0[g],
            rb_w1[g],
            rb_right[g],
            rb_lo_m[g],
            rb_hi_m[g],
        ) = _rank_bracket_row(fg, qv)
    g_in_chunk = (np.arange(Gp) % Gc)[:, None]
    rb_lo_flat = (g_in_chunk * Lt + rb_lo).astype(np.int32)
    rb_hi_flat = (g_in_chunk * Lt + rb_hi).astype(np.int32)

    def C(a, shape):  # chunk-stack
        return np.ascontiguousarray(a.reshape(NC, *shape))

    return StreamTables(
        fit_take=C(fit_take, (Gc * Lt,)),
        fit_mask=C(fit_mask, (Gc, Lt)),
        lo_w=C(lo_w, (Gc, ne)),
        lo_px=C(lo_px.astype(dtype), (Gc, ne)),
        hi_pos=C(hi_pos, (Gc * ne,)),
        hi_w=C(hi_w, (Gc, ne)),
        hi_px=C(hi_px.astype(dtype), (Gc, ne)),
        q_take=C(q_take, (Gc * Lq,)),
        q_mask=C(q_mask, (Gc, Lq)),
        q_pp=C(q_pp, (Gc, Lq)),
        trend_cols=C(rows.astype(np.int32), (Gc,)),
        rb_lo=C(rb_lo_flat, (Gc * Lq,)),
        rb_hi=C(rb_hi_flat, (Gc * Lq,)),
        rb_w0=C(rb_w0.astype(dtype), (Gc, Lq)),
        rb_w1=C(rb_w1.astype(dtype), (Gc, Lq)),
        rb_right=C(rb_right, (Gc, Lq)),
        rb_lo_m=C(rb_lo_m, (Gc, Lq)),
        rb_hi_m=C(rb_hi_m, (Gc, Lq)),
    )


class DeviceStreamTables(NamedTuple):
    """:class:`StreamTables` on a device (floats in the compute dtype,
    indices as int64), plus what the chunk loop derives from the host
    tables: the group-order layout of the output and whether each chunk's
    fit windows are one contiguous slice of a presorted source."""

    tabs: StreamTables  # of torch tensors
    host: StreamTables  # the numpy tables they came from
    flat_q: torch.Tensor  # (NC*Gc*Lq,) time step of each group-order slot
    inv_t: torch.Tensor  # (n_out,) group-order slot of each time step


@functools.lru_cache(maxsize=32)
def stream_tables_on(
    fit: PaddedGroups,
    transform: PaddedGroups,
    t2f_bytes: bytes,
    n_out: int,
    alpha,
    beta,
    n_endpoints: int,
    group_chunk: int,
    source: str,
    device,
    dtype,
) -> DeviceStreamTables:
    """:func:`build_stream_tables` on ``device`` (floats in ``dtype``,
    indices as int64), cached per (tables, device, dtype).  The transform
    groups must partition ``[0, n_out)``: the output is kept in group order
    and restored to time order by the inverse permutation."""
    host = build_stream_tables(
        fit, transform, np.frombuffer(t2f_bytes, dtype=np.int32), alpha=alpha, beta=beta,
        n_endpoints=n_endpoints, group_chunk=group_chunk, source=source,
    )
    flat_q = np.asarray(host.q_take).reshape(-1)
    flat_m = np.asarray(host.q_mask).reshape(-1)
    tgt = flat_q[flat_m]
    if tgt.size != n_out or not np.array_equal(np.sort(tgt), np.arange(n_out)):
        raise ValueError("the transform groups must partition the predict axis")
    inv_t = np.zeros(n_out, np.int64)
    inv_t[tgt] = np.nonzero(flat_m)[0]

    def dev(a):
        t = torch.as_tensor(np.ascontiguousarray(a))
        if t.is_floating_point():
            t = t.to(dtype)
        elif t.dtype != torch.bool:
            t = t.to(torch.long)
        return t.to(device)

    return DeviceStreamTables(
        StreamTables(*(dev(a) for a in host)), host, dev(flat_q), dev(inv_t)
    )


def _masked_trend_chunk(vals, mask, w):
    """Per-group linear trend vs within-group position (masked OLS against
    ``arange``): the chunk-local ``grouped._masked_trend``
    (``LinearTrendTransformer`` per sub-frame, ``quantile.py:97``)."""
    L = vals.shape[-1]
    t = torch.arange(L, dtype=vals.dtype, device=vals.device)
    return ols_1d(t, torch.where(mask, vals, 0.0), w)  # (..., Gc) each


def _fit_contiguous(source, host: StreamTables) -> bool:
    """True when chunk ``c``'s live fit windows sit at columns
    ``[c*Gc*Lt, (c+1)*Gc*Lt)`` of a presorted source (the slide kernel's
    flat output, or a dense state whose rows align), so each chunk reads
    one slice instead of a gather.  Dead (masked) rows may hold anything:
    every read of them is masked."""
    NC, GcLt = host.fit_take.shape
    Gc, Lt = host.fit_mask.shape[1:]
    if source.shape[-1] < NC * GcLt:
        return False
    ft = host.fit_take.reshape(NC, Gc, Lt)
    live = host.fit_mask.any(axis=-1)
    exp = np.arange(NC * GcLt).reshape(NC, Gc, Lt)
    return bool(np.array_equal(ft[live], exp[live]))


def streaming_qm_transform(
    source,
    x,
    tables: DeviceStreamTables,
    *,
    presorted: bool,
    extrapolate="both",
    detrend: bool = False,
    state_trend=None,
    out_init=None,
):
    """Grouped QM transform as a loop over transform-group chunks.

    ``source``: (..., Ns): raw fit series (``presorted=False``) or flat
    sorted state vals (``presorted=True``); ``x``: (..., Tp) query series.
    ``state_trend``: (slope (..., Gf), intercept (..., Gf)) when
    ``presorted`` and ``detrend``.  ``out_init``: (..., Tp) terms added to
    the output (the climate-trend shift, minus the climatology), folded into
    the carry.  Returns (..., Tp) with each query's mapped value at its time
    step.
    """
    tabs, host = tables.tabs, tables.host
    dtype = x.dtype
    lead = x.shape[:-1]
    NC, GcLt = host.fit_take.shape
    Gc, Lt = host.fit_mask.shape[1:]
    Lq = host.q_mask.shape[-1]
    K = Gc * Lq
    arL = torch.arange(Lt, dtype=dtype, device=x.device)
    arQ = torch.arange(Lq, dtype=dtype, device=x.device)
    fit_contig = presorted and _fit_contiguous(source, host)

    # the carry in GROUP order: chunk c owns columns [c*K, (c+1)*K)
    if out_init is None:
        carry = x.new_zeros((*lead, NC * K))
    else:
        carry = torch.broadcast_to(out_init, (*lead, x.shape[-1])).to(dtype).index_select(
            -1, tables.flat_q
        )

    for c in range(NC):
        fit_mask = tabs.fit_mask[c]  # (Gc, Lt)
        # -- fit window -> sorted per-group CDF values ------------------
        if fit_contig:
            src = source[..., c * GcLt : (c + 1) * GcLt].reshape(*lead, Gc, Lt)
        else:
            src = source.index_select(-1, tabs.fit_take[c]).reshape(*lead, Gc, Lt)
        if presorted:
            svals = src  # already sorted, +inf padded state rows
            if detrend:
                f_slope = state_trend[0].index_select(-1, tabs.trend_cols[c])
                f_intercept = state_trend[1].index_select(-1, tabs.trend_cols[c])
        else:
            if detrend:
                w = fit_mask.to(dtype)
                f_slope, f_intercept = _masked_trend_chunk(src, fit_mask, w)
                src = src - (f_slope[..., None] * arL + f_intercept[..., None])
            svals = _sort_groups_3d(torch.where(fit_mask, src, _INF), Lt)

        # -- queries: rank-bracket map through the fit CDF ----------------
        q_mask = tabs.q_mask[c]
        xq = x.index_select(-1, tabs.q_take[c]).reshape(*lead, Gc, Lq)
        if detrend:
            q_slope, q_intercept = _masked_trend_chunk(xq, q_mask, q_mask.to(dtype))
            q_line = q_slope[..., None] * arQ + q_intercept[..., None]
            xq = xq - q_line
        mq = torch.where(q_mask, xq, _INF)

        v_last = torch.where(fit_mask, svals, -_INF).amax(dim=-1, keepdim=True)
        vals_tab = torch.where(fit_mask, svals, v_last)

        sflat = svals.reshape(*lead, GcLt)
        f0 = sflat.index_select(-1, tabs.rb_lo[c]).reshape(*lead, Gc, Lq)
        f1 = sflat.index_select(-1, tabs.rb_hi[c]).reshape(*lead, Gc, Lq)
        df = f1 - f0
        res = torch.where(tabs.rb_right[c], f1 + tabs.rb_w1[c] * df, f0 + tabs.rb_w0[c] * df)

        if extrapolate in ("min", "both"):
            # vals_tab (finite pads), not svals: 0-weight pad slots would
            # otherwise put 0*inf = NaN into the weighted OLS sums
            lo_w = tabs.lo_w[c]
            lo_py = vals_tab[..., : lo_w.shape[-1]]
            lo_s, lo_i = ols_1d(tabs.lo_px[c], lo_py, lo_w)
            res = torch.where(tabs.rb_lo_m[c], lo_i[..., None] + lo_s[..., None] * tabs.q_pp[c], res)
        if extrapolate in ("max", "both"):
            hi_py = vals_tab.reshape(*lead, GcLt).index_select(-1, tabs.hi_pos[c])
            hi_py = hi_py.reshape(*lead, Gc, -1)
            hi_s, hi_i = ols_1d(tabs.hi_px[c], hi_py, tabs.hi_w[c])
            res = torch.where(tabs.rb_hi_m[c], hi_i[..., None] + hi_s[..., None] * tabs.q_pp[c], res)

        # np.interp tie semantics and original-order placement: K2
        res = apply_ranked_flat(res.reshape(*lead, K), mq.reshape(*lead, K), Lq)
        res = res.reshape(*lead, Gc, Lq)

        if detrend:
            res = res + q_line
            # intercept-bias reset (quantile.py:145)
            res = res - (q_intercept - f_intercept)[..., None]

        # in place: the carry's chunk slice is this chunk's alone
        carry[..., c * K : (c + 1) * K] += torch.where(q_mask, res, 0.0).reshape(*lead, K)

    return carry.index_select(-1, tables.inv_t)
