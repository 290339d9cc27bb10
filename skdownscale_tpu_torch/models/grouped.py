"""Ragged-group quantile mapping in a flat ``(cells, G*L)`` layout.

Port of the partition-group subset of ``skdownscale_tpu/models/grouped.py``
that the dense monthly BCSD path runs.  BCSD fits one quantile mapper per
time group; months have 28-31 days and records vary in length, so the group
CDFs are ragged.  Every group lives in a padded table and the Cunnane
transform and its inverse run on all groups of all cells at once.

Group structure (:class:`~skdownscale_tpu_torch.utils.timeindex.PaddedGroups`)
is host metadata.  PyTorch runs eagerly, so each host table is uploaded
once and cached as a device tensor, keyed by the table's source, the device
and the dtype, instead of being rebuilt on every call.

Padding conventions: sorted value tables pad with ``+inf``; plotting-position
tables repeat their last valid entry.  All functions take tensors with
arbitrary leading batch (cell) dims.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.rank_map import COUNT_SORT_MAX_LEN, count_sort_segments, rank_map_segments
from ..kernels.sort_rows import on_rows
from ..ops.interp import interp_rows
from ..ops.regression import ols_1d
from ..utils.timeindex import PaddedGroups

__all__ = [
    "GroupedCdf",
    "gather_groups",
    "scatter_groups",
    "cunnane_fit_padded",
    "cunnane_transform_padded",
    "cunnane_inverse_padded",
    "grouped_qm_fit",
    "grouped_qm_transform",
    "apply_ranked_flat",
    "apply_ranked_rows",
    "rank_bracket_tables",
]

_INF = float("inf")


class GroupedCdf(NamedTuple):
    """Per-group Cunnane CDFs in flat layout.

    ``vals``: (..., G*L) sorted ascending within each group, +inf padded;
    ``pp``: (G*L,) plotting positions (shared across batch; pads repeat the
    last valid).  Trend fields are zeros unless fit with ``detrend=True``.
    """

    pp: torch.Tensor  # (G*L,)
    vals: torch.Tensor  # (..., G*L)
    trend_slope: torch.Tensor  # (..., G)
    trend_intercept: torch.Tensor  # (..., G)

    shared_fields = ("pp",)  # no cell axis (models/batched.py: split_cells)


# ----------------------------------------------------------------------
# host tables and their cached device copies
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _group_tables(groups: PaddedGroups, device: torch.device):
    """(flat member index, flat mask, (G, L) mask) of ``groups`` on ``device``."""
    return (
        torch.as_tensor(groups.indices.reshape(-1), dtype=torch.long).to(device),
        torch.as_tensor(groups.mask.reshape(-1)).to(device),
        torch.as_tensor(groups.mask).to(device),
    )


@functools.lru_cache(maxsize=256)
def _inverse_perm(groups: PaddedGroups, n: int) -> np.ndarray | None:
    """Host inverse of a partition grouping: ``inv[t]`` = flat (g, l) slot of
    time step ``t``, or None if the groups don't cover [0, n) exactly once."""
    flat_idx = groups.indices.reshape(-1)
    mask = groups.mask.reshape(-1)
    tgt = flat_idx[mask]
    if tgt.size != n or not np.array_equal(np.sort(tgt), np.arange(n)):
        return None
    inv = np.zeros(n, np.int32)
    inv[tgt] = np.nonzero(mask)[0].astype(np.int32)
    return inv


@functools.lru_cache(maxsize=256)
def _inverse_perm_dev(groups: PaddedGroups, n: int, device: torch.device):
    inv = _inverse_perm(groups, n)
    return None if inv is None else torch.as_tensor(inv, dtype=torch.long).to(device)


def _padded_pp_from_counts(counts, L: int, alpha: float, beta: float) -> np.ndarray:
    """Host Cunnane plotting positions (G, L) from per-group counts; padding
    repeats the last valid position (monotone table with zero pad slope)."""
    i = np.arange(1, L + 1, dtype=np.float64)[None, :]
    n = np.asarray(counts, np.float64)[:, None]
    return (np.minimum(i, np.maximum(n, 1)) - alpha) / (n + 1.0 - alpha - beta)


def _padded_pp(groups: PaddedGroups, alpha: float, beta: float) -> np.ndarray:
    """Flat (G*L,) flavor of :func:`_padded_pp_from_counts`."""
    G, L = groups.indices.shape
    return _padded_pp_from_counts(groups.counts, L, alpha, beta).reshape(-1)


@functools.lru_cache(maxsize=256)
def _padded_pp_dev(groups: PaddedGroups, alpha, beta, device, dtype):
    return torch.as_tensor(_padded_pp(groups, alpha, beta), dtype=dtype).to(device)


# ----------------------------------------------------------------------
# gather / scatter
# ----------------------------------------------------------------------


def gather_groups(x, groups: PaddedGroups, fill=_INF):
    """Gather ``x`` (..., T) into flat padded group rows (..., G*L)."""
    idx, mask, _ = _group_tables(groups, x.device)
    return torch.where(mask, x.index_select(-1, idx), fill)


def scatter_groups(vals_flat, groups: PaddedGroups, n: int):
    """Scatter flat padded group rows (..., G*L) back to (..., n).  The
    groups must be a partition of ``[0, n)`` (each time index in exactly one
    (group, slot)), so the scatter is a gather by the host inverse
    permutation."""
    inv = _inverse_perm_dev(groups, n, vals_flat.device)
    if inv is None:
        raise ValueError("scatter_groups needs a partition of the time axis")
    return vals_flat.index_select(-1, inv)


# ----------------------------------------------------------------------
# fit
# ----------------------------------------------------------------------


def _sort_segments(flat, L: int):
    """Sort each length-``L`` segment of a (rows, G*L) table: the segment
    count-sort K1 up to ``COUNT_SORT_MAX_LEN``, above it the row sort K9 on
    the (rows*G, L) view (the dense daily fit's 620-wide windows; the JAX
    package's ``grouped.py:170`` and ``streaming.py:75`` sites) at any
    length: a shape route, taken before any launch.  Both give the same
    bits."""
    if L <= COUNT_SORT_MAX_LEN:
        return count_sort_segments(flat, L)
    return on_rows("sort_rows", flat.reshape(-1, L)).reshape(flat.shape)


def _sort_within_groups(vflat, groups: PaddedGroups):
    """Sort each group's slots by value on the flat (rows, G*L) table."""
    G, L = groups.indices.shape
    return _sort_segments(vflat.reshape(-1, G * L), L).reshape(vflat.shape)


def _masked_trend(xg_flat, groups: PaddedGroups):
    """Per-group linear trend vs within-group position (masked OLS against
    ``arange``), matching ``LinearTrendTransformer`` fit on each group's
    sub-frame (``quantile.py:97``)."""
    G, L = groups.indices.shape
    lead = xg_flat.shape[:-1]
    xg = xg_flat.reshape(*lead, G, L)
    _, _, mask2 = _group_tables(groups, xg_flat.device)
    t = torch.arange(L, dtype=xg_flat.dtype, device=xg_flat.device)
    w = mask2.to(xg_flat.dtype)
    return ols_1d(t, torch.where(mask2, xg, 0.0), w)  # (..., G) each


def _trend_line_flat(slope, intercept, groups: PaddedGroups, dtype):
    G, L = groups.indices.shape
    t = torch.arange(L, dtype=dtype, device=slope.device)
    line = slope[..., None] * t + intercept[..., None]  # (..., G, L)
    return line.reshape(*slope.shape[:-1], G * L)


def _detrend_flat(xg_flat, slope, intercept, groups: PaddedGroups):
    """Flat padded group rows (..., G*L) less each group's trendline, the
    intercept first (as :func:`~.trend.trend_transform`)."""
    G, L = groups.indices.shape
    t = torch.arange(L, dtype=xg_flat.dtype, device=xg_flat.device)
    xg = xg_flat.reshape(*slope.shape[:-1], G, L)
    return ((xg - intercept[..., None]) - slope[..., None] * t).reshape(xg_flat.shape)


def cunnane_fit_padded(
    xg_flat, groups: PaddedGroups, *, alpha: float = 0.4, beta: float = 0.4, detrend: bool = False
) -> GroupedCdf:
    """Fit per-group Cunnane CDFs from flat padded group rows (..., G*L)."""
    dtype = xg_flat.dtype
    lead = xg_flat.shape[:-1]
    if detrend:
        slope, intercept = _masked_trend(xg_flat, groups)
        xg_flat = _detrend_flat(xg_flat, slope, intercept, groups)
    else:
        slope = torch.zeros((*lead, groups.n_groups), dtype=dtype, device=xg_flat.device)
        intercept = torch.zeros_like(slope)
    _, mask, _ = _group_tables(groups, xg_flat.device)
    masked = torch.where(mask, xg_flat, _INF)
    vals = _sort_within_groups(masked, groups)
    pp = _padded_pp_dev(groups, alpha, beta, xg_flat.device, dtype)
    return GroupedCdf(pp, vals, slope, intercept)


def grouped_qm_fit(
    y,
    groups: PaddedGroups,
    *,
    alpha: float = 0.4,
    beta: float = 0.4,
    detrend: bool = False,
) -> GroupedCdf:
    """``BcsdBase._qm_fit_by_group`` (``bcsd.py:59-67``): one QuantileMapper
    CDF per padded group of ``y`` (..., T)."""
    yg = gather_groups(y, groups, fill=0.0)
    return cunnane_fit_padded(yg, groups, alpha=alpha, beta=beta, detrend=detrend)


# ----------------------------------------------------------------------
# transform
# ----------------------------------------------------------------------


def _rank_bracket_row(fg: np.ndarray, qv: np.ndarray):
    """Host-side rank-bracket interp plan for ONE group.

    Both the query plotting-position grid ``qv`` (Lq,) and the fit knot grid
    ``fg`` (nf valid knots, strictly increasing) are pure functions of
    (rank, count), so the bracketing knot indices, the nearer-knot lerp
    weights, and the clamp/tail regions of ``np.interp``-with-tails are all
    data-independent.  Returns ``(lo, hi, w0, w1, right, below, above)``
    with shapes (Lq,).
    """
    nf = len(fg)
    below = qv < fg[0]
    above = qv > fg[nf - 1]
    lo = np.clip(np.searchsorted(fg, qv, side="right") - 1, 0, nf - 1)
    hi = np.minimum(lo + 1, nf - 1)
    lo = np.where(below, 0, np.where(above, nf - 1, lo))
    hi = np.where(below, 0, np.where(above, nf - 1, hi))
    x0 = fg[lo]
    x1 = fg[hi]
    dx = x1 - x0
    dxs = np.where(dx != 0, dx, 1.0)
    inner = ~(below | above) & (dx != 0)
    w0 = np.where(inner, (qv - x0) / dxs, 0.0)
    w1 = np.where(inner, (qv - x1) / dxs, 0.0)
    right = ~(below | above) & ((qv - x0) > (x1 - qv))
    return lo, hi, w0, w1, right, below, above


def rank_bracket_tables(
    fit_counts: np.ndarray,
    q_pp: np.ndarray,
    Lt: int,
    *,
    alpha: float,
    beta: float,
):
    """Stacked host rank-bracket plans for G groups.

    ``fit_counts``: (G,) valid fit knots per group; ``q_pp``: (G, Lq) query
    rank plotting positions.  The fit knot grid is reconstructed from the
    Cunnane formula (``_padded_pp``), which is how every fit table in this
    module was built.  Returns dict of (G, Lq) arrays plus flat take
    indices (G*Lq,) into a (G*Lt) value table.
    """
    G, Lq = q_pp.shape
    lo = np.zeros((G, Lq), np.int64)
    hi = np.zeros((G, Lq), np.int64)
    w0 = np.zeros((G, Lq), np.float64)
    w1 = np.zeros((G, Lq), np.float64)
    right = np.zeros((G, Lq), bool)
    below = np.zeros((G, Lq), bool)
    above = np.zeros((G, Lq), bool)
    for g in range(G):
        nf = int(fit_counts[g])
        if nf <= 0:
            continue
        i = np.arange(1, nf + 1, dtype=np.float64)
        fg = (i - alpha) / (nf + 1.0 - alpha - beta)
        lo[g], hi[g], w0[g], w1[g], right[g], below[g], above[g] = _rank_bracket_row(
            fg, np.asarray(q_pp[g], np.float64)
        )
    g_off = (np.arange(G) * Lt)[:, None]
    return {
        "lo_flat": (g_off + lo).reshape(-1).astype(np.int32),
        "hi_flat": (g_off + hi).reshape(-1).astype(np.int32),
        "w0": w0,
        "w1": w1,
        "right": right,
        "below": below,
        "above": above,
    }


def _tail_windows(counts: np.ndarray, L: int, n_endpoints: int):
    """Host-precomputed tail-window column indices and 0/1 weights."""
    ne = min(n_endpoints, L)
    j = np.arange(ne)[None, :]
    w_lo = (j < counts[:, None]).astype(np.float64)  # first ne valid knots
    start = np.maximum(counts - ne, 0)[:, None]
    hi_cols = (start + j).astype(np.int64)  # last ne valid knots
    w_hi = ((start + j) < counts[:, None]).astype(np.float64)
    return ne, w_lo, hi_cols, w_hi


def _cunnane_map_flat(
    q_flat, table_x_flat, table_y_flat, groups_q: PaddedGroups, counts: np.ndarray,
    L_table: int, extrapolate, n_endpoints: int,
):
    """Shared ragged map for transform (vals -> pp) and inverse (pp -> vals),
    semantics of ``quantile.py:485-503`` / ``523-545``: K6 through
    :func:`~..ops.interp.interp_rows` on every (cell, group) row, then the
    OLS tails over the host tail windows.

    ``q_flat``: (..., G*Lq) queries grouped per ``groups_q``;
    ``table_*_flat``: (..., G*L_table) or (G*L_table,) monotone-per-group
    tables; ``counts``: host (G,) valid knots per table group.
    """
    dtype, dev = q_flat.dtype, q_flat.device
    lead = q_flat.shape[:-1]
    G, Lq = groups_q.indices.shape
    Lt = L_table

    tx = torch.broadcast_to(table_x_flat, (*lead, G * Lt)).reshape(*lead, G, Lt)
    ty = torch.broadcast_to(table_y_flat, (*lead, G * Lt)).reshape(*lead, G, Lt)
    q3 = q_flat.reshape(*lead, G, Lq)
    res = interp_rows(tx, ty, q3)  # (..., G, Lq)

    if extrapolate in ("min", "max", "both"):
        ne, w_lo, hi_cols, w_hi = _tail_windows(counts, Lt, n_endpoints)
        g_idx = torch.arange(G, device=dev)
        last = torch.as_tensor(np.maximum(counts - 1, 0), dtype=torch.long, device=dev)
        if extrapolate in ("min", "both"):
            lo_s, lo_i = ols_1d(tx[..., :ne], ty[..., :ne], torch.as_tensor(w_lo, dtype=dtype, device=dev))
            res = torch.where(q3 < tx[..., :, 0:1], lo_i[..., None] + lo_s[..., None] * q3, res)
        if extrapolate in ("max", "both"):
            cols = torch.as_tensor(hi_cols, device=dev)
            hx = tx[..., g_idx[:, None], cols]  # (..., G, ne)
            hy = ty[..., g_idx[:, None], cols]
            hi_s, hi_i = ols_1d(hx, hy, torch.as_tensor(w_hi, dtype=dtype, device=dev))
            hi_edge = tx[..., g_idx, last][..., None]
            res = torch.where(q3 > hi_edge, hi_i[..., None] + hi_s[..., None] * q3, res)
    return res.reshape(*lead, G * Lq)


def cunnane_transform_padded(
    cdf: GroupedCdf, xg_flat, groups_q: PaddedGroups, counts: np.ndarray,
    extrapolate="both", n_endpoints: int = 10,
):
    """values -> plotting positions per group; ``xg_flat``: (..., G*Lq)
    grouped per ``groups_q`` against the cdf's G groups (row-aligned)."""
    Lt = cdf.vals.shape[-1] // groups_q.n_groups
    return _cunnane_map_flat(
        xg_flat, cdf.vals, cdf.pp, groups_q, counts, Lt, extrapolate, n_endpoints
    )


def cunnane_inverse_padded(
    cdf: GroupedCdf, qg_flat, groups_q: PaddedGroups, counts: np.ndarray,
    valid_flat: np.ndarray, extrapolate="both", n_endpoints: int = 10,
):
    """plotting positions -> values per group; ``qg_flat``: (..., G*Lq).

    Builds the (pp -> vals) direction tables: pp pads to +inf, vals pads to
    each group's last valid value (monotone, zero slope into the pad).
    """
    G = groups_q.n_groups
    Lt = cdf.vals.shape[-1] // G
    lead = cdf.vals.shape[:-1]
    valid = torch.as_tensor(np.asarray(valid_flat, dtype=bool), device=cdf.vals.device)
    pp_tab = torch.where(valid, cdf.pp, _INF)
    valid2 = valid.reshape(G, Lt)
    vals3 = cdf.vals.reshape(*lead, G, Lt)
    v_last = torch.where(valid2, vals3, -_INF).amax(dim=-1, keepdim=True)
    vals_tab = torch.where(valid2, vals3, v_last).reshape(*lead, G * Lt)
    return _cunnane_map_flat(
        qg_flat, pp_tab, vals_tab, groups_q, counts, Lt, extrapolate, n_endpoints
    )


@functools.lru_cache(maxsize=64)
def _transform_tables(
    groups: PaddedGroups, counts_bytes: bytes, valid_bytes: bytes, Lt: int,
    alpha, beta, n_endpoints: int, device, dtype,
):
    """Device copies of every host table :func:`grouped_qm_transform` reads:
    rank-bracket takes and weights, tail windows and knot positions."""
    G, L = groups.indices.shape
    fit_counts = np.frombuffer(counts_bytes, dtype=np.int32).copy()
    q_pp_host = _padded_pp(groups, alpha, beta).reshape(G, L)
    rb = rank_bracket_tables(fit_counts, q_pp_host, Lt, alpha=alpha, beta=beta)
    ne, w_lo, hi_cols, w_hi = _tail_windows(fit_counts, Lt, n_endpoints)
    fpp = _padded_pp_from_counts(fit_counts, Lt, alpha, beta)  # (G, Lt)

    def f(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    def i(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.long).to(device)

    def b(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=bool)).to(device)

    return {
        "lo_flat": i(rb["lo_flat"]),
        "hi_flat": i(rb["hi_flat"]),
        "w0": f(rb["w0"].reshape(-1)),
        "w1": f(rb["w1"].reshape(-1)),
        "right": b(rb["right"].reshape(-1)),
        "below": b(rb["below"].reshape(-1)),
        "above": b(rb["above"].reshape(-1)),
        "ne": ne,
        "w_lo": f(w_lo),
        "w_hi": f(w_hi),
        "g_idx": i(np.arange(G)[:, None]),
        "hi_cols": i(hi_cols),
        "lo_px": f(fpp[:, :ne]),
        "hi_px": f(np.take_along_axis(fpp, hi_cols, axis=1)),
        "valid": b(np.frombuffer(valid_bytes, dtype=bool).reshape(G, Lt).copy()),
        "qpp": f(q_pp_host),
    }


def apply_ranked_flat(res_flat, q_flat, L: int):
    """Map each query to its rank's result value within its length-``L``
    segment of the flat (..., G*L) layout, with np.interp's tie semantics
    (every tied query takes the run end's value) and NaN passthrough: the
    segment rank-map K2.

    ``res_flat``: (..., G*L) mapped values by RANK (query-independent:
    rank-bracket takes through the fit CDF); ``q_flat``: (..., G*L) query
    values in original order (+inf padded)."""
    lead = q_flat.shape[:-1]
    GL = q_flat.shape[-1]
    q2 = q_flat.reshape(-1, GL).contiguous()
    r2 = torch.broadcast_to(res_flat, q_flat.shape).reshape(-1, GL).contiguous()
    return rank_map_segments(q2, r2, L).reshape(*lead, GL)


def apply_ranked_rows(res_rows, q_rows):
    """(rows, L) flavor of :func:`apply_ranked_flat`: one segment per row."""
    return rank_map_segments(q_rows.contiguous(), res_rows.contiguous(), q_rows.shape[-1])


def grouped_qm_transform(
    fit_cdf: GroupedCdf,
    fit_counts: np.ndarray,
    fit_valid_flat: np.ndarray,
    x,
    groups: PaddedGroups,
    *,
    alpha: float = 0.4,
    beta: float = 0.4,
    extrapolate="both",
    n_endpoints: int = 10,
    detrend: bool = False,
):
    """``BcsdBase._qm_transform_by_group`` (``bcsd.py:69-79``) on padded
    partition groups: per group, build a fresh CDF of the new values,
    transform to plotting positions, then inverse through the stored fit CDF
    (rows pre-aligned to ``groups``); scatter back to (..., len(x)).

    ``fit_counts``/``fit_valid_flat``: host count vector / flat (G*Lt,)
    validity mask of the *fit* tables (aligned to this partition's rows).
    ``alpha``/``beta`` must be the pair the fit CDF was built with.

    fit_transform-on-self gives rank plotting positions, and the inverse
    interp of a rank pp through the fit pp grid is bracket-determined by
    (rank, counts) alone, so the vals->pp->vals chain collapses to host
    rank-bracket takes plus one rank map (K2).
    """
    dtype = x.dtype
    dev = x.device
    xg_raw = gather_groups(x, groups, fill=0.0)
    if detrend:
        slope, intercept = _masked_trend(xg_raw, groups)
        xg = _detrend_flat(xg_raw, slope, intercept, groups)
    else:
        xg = xg_raw
    G, L = groups.indices.shape
    Lt = fit_cdf.vals.shape[-1] // G
    _, mask, _ = _group_tables(groups, dev)
    masked = torch.where(mask, xg, _INF)
    lead = xg.shape[:-1]
    tb = _transform_tables(
        groups,
        np.ascontiguousarray(fit_counts, dtype=np.int32).tobytes(),
        np.ascontiguousarray(fit_valid_flat, dtype=bool).tobytes(),
        Lt, alpha, beta, n_endpoints, dev, dtype,
    )

    vals_b = torch.broadcast_to(fit_cdf.vals, (*lead, G * Lt))
    f0 = vals_b.index_select(-1, tb["lo_flat"])
    f1 = vals_b.index_select(-1, tb["hi_flat"])
    df = f1 - f0
    res = torch.where(tb["right"], f1 + tb["w1"] * df, f0 + tb["w0"] * df)

    if extrapolate in ("min", "max", "both"):
        ne = tb["ne"]
        valid = tb["valid"]
        vals3 = vals_b.reshape(*lead, G, Lt)
        v_last = torch.where(valid, vals3, -_INF).amax(dim=-1, keepdim=True)
        vals_tab = torch.where(valid, vals3, v_last)
        qpp = tb["qpp"]  # (G, L)
        if extrapolate in ("min", "both"):
            lo_s, lo_i = ols_1d(tb["lo_px"], vals_tab[..., :ne], tb["w_lo"])
            line = (lo_i[..., None] + lo_s[..., None] * qpp).reshape(*lead, G * L)
            res = torch.where(tb["below"], line, res)
        if extrapolate in ("max", "both"):
            hy = vals_tab[..., tb["g_idx"], tb["hi_cols"]]  # (..., G, ne)
            hi_s, hi_i = ols_1d(tb["hi_px"], hy, tb["w_hi"])
            line = (hi_i[..., None] + hi_s[..., None] * qpp).reshape(*lead, G * L)
            res = torch.where(tb["above"], line, res)

    mapped = apply_ranked_flat(res, masked, L)
    if detrend:
        mapped = mapped + _trend_line_flat(slope, intercept, groups, dtype)
        # intercept-bias reset (quantile.py:145)
        delta = (intercept - fit_cdf.trend_intercept)[..., None]
        mapped = mapped - torch.broadcast_to(delta, (*delta.shape[:-1], L)).reshape(
            *mapped.shape[:-1], G * L
        )
    return scatter_groups(mapped, groups, x.shape[-1])
