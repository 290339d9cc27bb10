"""Plain reference of MBCn (Cannon 2018, Clim. Dyn. 50:31-49), the
N-dimensional probability density function transform, as the benchmark's
MBCn configuration runs it: QDM margins of the difference kind, then one
round a rotation of a seeded orthogonal stack, then the margins reordered
to the ranks of the iterated data.

Plain PyTorch, batched over cells; it imports nothing of the program under
test.  Inputs ``obs (C, m, d)``, ``hist (C, n, d)``, ``fut (C, p, d)``.

1. Margins, one variable at a time (scikit-downscale's
   ``EquidistantCdfMatcher(kind="difference", extrapolate="both")`` fitted
   on (hist, obs)): each block's sorted values get the extrapolated
   Cunnane CDF (``calc_extrapolated_cdf``: plotting positions bracketed by
   -1e20 and 1e20, end values by least squares over ``n_endpoints``
   knots); the fit's hist and obs values at the block's plotting
   positions (``np.interp``); the corrected sorted values are
   ``obs_at + (block - hist_at)``, put back in the block's time order.
2. For each rotation ``Q``: obs, hist and fut rotated (``@ Q``); each
   rotated hist column quantile-mapped onto the rotated obs column (its
   rank's plotting position through the obs CDF, ``np.interp``, ends
   clamped); each rotated fut column through the same transfer function
   (``np.interp`` on the sorted hist column and its mapped values); both
   rotated back (``@ Q.T``).
3. Each margin column reordered so that its ranks are those of the
   iterated column (a stable sort of each).

``dtype`` is the precision the reference computes in; ``tf32=True`` rounds
the operands of every rotation product to TF32 (10 bits of mantissa,
round to nearest), the precision a card's TF32 matrix units take them in,
with float32 accumulation; ``margin_dtype`` computes the margins in
another precision.  The last two make the controls.
"""

from __future__ import annotations

import numpy as np
import torch

from .quantile_mapper import interp, ols, plotting_positions

SYNTHETIC = 1e20
N_ENDPOINTS = 10


def rotations(d: int, n: int, seed: int) -> np.ndarray:
    """``(n, d, d)`` Haar-random orthogonal matrices from ``seed``: the QR
    factor of a standard normal matrix, its columns signed by the diagonal
    of R."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, d, d), dtype=np.float64)
    for r in range(n):
        q, rr = np.linalg.qr(rng.standard_normal((d, d)))
        out[r] = q * np.sign(np.diag(rr))
    return out


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32's 10 bits of mantissa (to nearest,
    ties away from zero)."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        return to_tf32(a.float()) @ to_tf32(b.float())
    return a @ b


def extrapolated_cdf(sorted_rows: torch.Tensor, n_endpoints=N_ENDPOINTS):
    """(pp (n+2,), vals (rows, n+2)) of ``calc_extrapolated_cdf(...,
    extrapolate="both")`` on sorted rows."""
    rows, n = sorted_rows.shape
    core = plotting_positions(n, sorted_rows.dtype, sorted_rows.device)
    ne = min(n_endpoints, n)
    lo_s, lo_i = ols(core[:ne], sorted_rows[:, :ne])
    hi_s, hi_i = ols(core[-ne:], sorted_rows[:, -ne:])
    big = torch.tensor([SYNTHETIC], dtype=core.dtype, device=core.device)
    pp = torch.cat([-big, core, big])
    vals = torch.cat([(lo_i - lo_s * SYNTHETIC)[:, None], sorted_rows, (hi_i + hi_s * SYNTHETIC)[:, None]], dim=1)
    return pp, vals


def unsort(sorted_vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(sorted_vals).scatter_(-1, pos, sorted_vals)


def qdm_rows(hist: torch.Tensor, obs: torch.Tensor, block: torch.Tensor):
    """Difference-kind QDM of ``block`` rows against the (hist, obs) fit."""
    hpp, hvals = extrapolated_cdf(torch.sort(hist, dim=-1).values)
    opp, ovals = extrapolated_cdf(torch.sort(obs, dim=-1).values)
    s = torch.sort(block, dim=-1, stable=True)
    bpp, bvals = extrapolated_cdf(s.values)
    q = bpp.expand(block.shape[0], -1)
    corrected = interp(q, opp, ovals) + (bvals - interp(q, hpp, hvals))
    return unsort(corrected[:, 1:-1], s.indices)


def rows_of(a: torch.Tensor) -> torch.Tensor:
    """(C, T, d) -> (C * d, T)."""
    C, T, d = a.shape
    return a.transpose(1, 2).reshape(C * d, T)


def cols_of(r: torch.Tensor, C: int) -> torch.Tensor:
    """(C * d, T) -> (C, T, d)."""
    T = r.shape[-1]
    return r.reshape(C, -1, T).transpose(1, 2)


def margins(obs, hist, fut):
    """QDM margins of hist and fut, ``(C * d, n)`` and ``(C * d, p)`` rows."""
    ho, hh, hf = rows_of(obs), rows_of(hist), rows_of(fut)
    return qdm_rows(hh, ho, hh), qdm_rows(hh, ho, hf)


def reorder(margin_rows: torch.Tensor, template_rows: torch.Tensor) -> torch.Tensor:
    """Each margin row permuted to the ranks of its template row."""
    pos = torch.sort(template_rows, dim=-1, stable=True).indices
    return unsort(torch.sort(margin_rows, dim=-1).values, pos)


def mbcn(obs, hist, fut, rots, dtype=torch.float64, tf32=False, margin_dtype=None):
    """MBCn of each cell: ``(hist_out (C, n, d), fut_out (C, p, d))`` in
    ``dtype``; ``rots`` ``(R, d, d)``.  ``margin_dtype`` (default
    ``dtype``) is the precision of the QDM margins."""
    mh, mf = margins(*(t.to(margin_dtype or dtype) for t in (obs, hist, fut)))
    mh, mf = mh.to(dtype), mf.to(dtype)
    obs, hist, fut = (t.to(dtype) for t in (obs, hist, fut))
    C, n, d = hist.shape
    m = obs.shape[1]
    zh, zf = cols_of(mh, C), cols_of(mf, C)
    pp_n = plotting_positions(n, dtype, hist.device)
    pp_m = plotting_positions(m, dtype, hist.device)
    for Q in torch.as_tensor(rots, dtype=dtype, device=hist.device):
        yr, zhr, zfr = (rows_of(matmul(t, Q, tf32).to(dtype)) for t in (obs, zh, zf))
        ys = torch.sort(yr, dim=-1).values
        s = torch.sort(zhr, dim=-1, stable=True)
        mapped = interp(pp_n.expand(ys.shape[0], n), pp_m, ys)
        zh_m = unsort(mapped, s.indices)
        zf_m = interp(zfr, s.values, mapped)
        zh = matmul(cols_of(zh_m, C), Q.T, tf32).to(dtype)
        zf = matmul(cols_of(zf_m, C), Q.T, tf32).to(dtype)
    return cols_of(reorder(mh, rows_of(zh)), C), cols_of(reorder(mf, rows_of(zf)), C)
