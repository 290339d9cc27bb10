"""Multivariate bias correction: the MBCn N-pdf transform.

Port of ``skdownscale_tpu/models/mbc.py``: Cannon's MBCn (Cannon 2018,
"Multivariate quantile mapping bias correction: an N-dimensional
probability density function transform", Climate Dynamics 50) as batched
cores over ``(..., T, d)`` tensors (leading dims are grid cells), a grid
runner and an sklearn-style wrapper.

1. **Margins** (:func:`mbcn_margins`): each variable is corrected with the
   QDM core (:func:`~.quantile.qmr_fit` + :func:`~.quantile.edcdfm_predict`,
   difference or ratio kind per variable).
2. **Dependence** (:func:`mbcn_iterate`): starting from the QDM-corrected
   data, one round per rotation of a seeded orthogonal stack: rotate (obs,
   hist, fut), empirically quantile-map each rotated hist coordinate onto
   the rotated obs coordinate (the fut block through the same transfer
   function by monotone interpolation, K6), rotate back.
3. **Reorder** (:func:`mbcn_reorder`): the QDM margins reordered to the
   ranks of the iterated data, separately for the hist and fut blocks.

Every row sort runs the row sort K9 (:mod:`..kernels.sort_rows`) on the
contiguous ``(cells*d, L)`` view: the value sort of the rotated obs, the
stable sort with positions of the rotated hist, and the unsort of the
mapped values by those positions; the closing reorder runs all three again.
Both Cunnane plotting-position grids are functions of (rank, length) only,
so the in-loop map is host tables (:func:`_rank_bracket`): per rank, two
takes from the sorted obs row and an fma.  The JAX package's ``lax.scan``
over the rotations is a Python loop here.

Ties take distinct ranks in input order (a stable sort), as the JAX
package's ``lax.sort(..., is_stable=True)`` gives.  Rows longer than
``K9_MAX_LEN`` take K9's plain version (:func:`..kernels.sort_rows.on_rows`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.sort_rows import on_rows
from ..ops.interp import interp_rows
from ..parallel.mesh import CellMesh, gather_objects, on_device
from .base import SingleCellEstimator, asarray_2d
from .quantile import edcdfm_predict, qmr_fit

__all__ = [
    "mbcn_rotations",
    "mbcn_margins",
    "mbcn_iterate",
    "mbcn_reorder",
    "mbcn_correct",
    "mbcn_correct_monthly",
    "mbcn_grid",
    "rank_reorder",
    "MBCn",
]


def rank_reorder(values, template):
    """Schaake-shuffle-style reordering: permute each row of ``values`` so
    its rank structure matches ``template``'s (both ``(..., n)``).

    The output is an exact permutation of ``values`` per row, with
    ``rank(out[i]) == rank(template[i])``: one row sort of ``values``, one
    sort of ``template`` with positions, and the unsort of the sorted
    values by those positions (K9's three forms)."""
    vs = on_rows("sort_rows", values)
    _, pos = on_rows("sort_rows_with_positions", template)
    return on_rows("unsort_rows", vs, pos)


def mbcn_rotations(d: int, n_iterations: int, random_state: int = 0) -> np.ndarray:
    """Host ``(n_iterations, d, d)`` stack of uniformly random orthogonal
    matrices (QR of a standard normal, sign-fixed so the factor is Haar)."""
    rng = np.random.default_rng(random_state)
    out = np.empty((n_iterations, d, d), dtype=np.float64)
    for r in range(n_iterations):
        q, rr = np.linalg.qr(rng.standard_normal((d, d)))
        out[r] = q * np.sign(np.diag(rr))
    return out


@functools.lru_cache(maxsize=None)
def _rank_bracket(n: int, m: int, alpha: float, beta: float):
    """Host tables mapping hist rank r (of n) into the sorted obs row (m):
    bracket indices (lo, hi) and lerp weight w such that
    ``mapped[r] = obs_sorted[lo]*(1-w) + obs_sorted[hi]*w`` equals
    ``np.interp(pp_n[r], pp_m, obs_sorted)`` (tails clamp)."""
    pp_n = (np.arange(1, n + 1, dtype=np.float64) - alpha) / (n + 1.0 - alpha - beta)
    pp_m = (np.arange(1, m + 1, dtype=np.float64) - alpha) / (m + 1.0 - alpha - beta)
    hi = np.searchsorted(pp_m, pp_n, side="left").astype(np.int32)
    lo = np.clip(hi - 1, 0, m - 1)
    hi = np.clip(hi, 0, m - 1)
    denom = pp_m[hi] - pp_m[lo]
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.where(denom > 0, (pp_n - pp_m[lo]) / np.where(denom > 0, denom, 1.0), 0.0)
    w = np.clip(w, 0.0, 1.0)
    return lo, hi, w


@functools.lru_cache(maxsize=64)
def _rank_bracket_dev(n: int, m: int, alpha: float, beta: float, device, dtype):
    """Device copies of :func:`_rank_bracket`: (lo, hi) as int64, w in ``dtype``."""
    lo, hi, w = _rank_bracket(n, m, alpha, beta)
    return (
        torch.as_tensor(lo, dtype=torch.long).to(device),
        torch.as_tensor(hi, dtype=torch.long).to(device),
        torch.as_tensor(w, dtype=dtype).to(device),
    )


def _qm_rows_by_rank(z, ys, lo, hi, w):
    """Empirical QM of each row of ``z`` (..., n) onto the sorted obs rows
    ``ys`` (..., m) through the rank-bracket tables (``lo``, ``hi``, ``w``
    tensors); returns the mapped rows in original order plus (sorted z,
    mapped-sorted) as the monotone transfer table for the fut block."""
    zs, pos = on_rows("sort_rows_with_positions", z)
    mapped_sorted = ys.index_select(-1, lo) * (1.0 - w) + ys.index_select(-1, hi) * w
    return on_rows("unsort_rows", mapped_sorted, pos), zs, mapped_sorted


def _kinds_tuple(kind, d: int) -> tuple:
    return (kind,) * d if isinstance(kind, str) else tuple(kind)


def mbcn_margins(y_obs, x_hist, x_fut, *, kinds, extrapolate="both", n_endpoints: int = 10):
    """Step 1, the QDM margins by kind: ``(..., m, d)``, ``(..., n, d)``,
    ``(..., p, d)`` -> (hist margins ``(..., d, n)``, fut margins
    ``(..., d, p)``), one row per variable."""
    d = x_hist.shape[-1]
    xh_rows = x_hist.transpose(-1, -2)  # (..., d, n)
    xf_rows = x_fut.transpose(-1, -2)
    yo_rows = y_obs.transpose(-1, -2)
    mh_cols: list = [None] * d
    mf_cols: list = [None] * d
    for kind in sorted(set(kinds)):
        idx = [j for j, k in enumerate(kinds) if k == kind]
        sel = torch.as_tensor(idx, dtype=torch.long, device=x_hist.device)
        xh_k = xh_rows.index_select(-2, sel)
        state = qmr_fit(
            xh_k, yo_rows.index_select(-2, sel), extrapolate=extrapolate, n_endpoints=n_endpoints
        )
        mh = edcdfm_predict(state, xh_k, kind=kind, extrapolate=extrapolate, n_endpoints=n_endpoints)
        mf = edcdfm_predict(
            state, xf_rows.index_select(-2, sel), kind=kind,
            extrapolate=extrapolate, n_endpoints=n_endpoints,
        )
        for pos, j in enumerate(idx):
            mh_cols[j] = mh[..., pos, :]
            mf_cols[j] = mf[..., pos, :]
    return torch.stack(mh_cols, dim=-2), torch.stack(mf_cols, dim=-2)


def mbcn_iterate(y_obs, mh_rows, mf_rows, rotations, lo, hi, w):
    """Step 2, the dependence rounds, starting from the margins (rows per
    variable): for each ``(d, d)`` rotation ``Q`` of ``rotations``, K9 sorts
    the rotated obs rows, :func:`_qm_rows_by_rank` maps the rotated hist
    rows (K9 with positions, the bracket takes and fma, K9 unsort), K6
    carries the fut rows through the same transfer table, and both rotate
    back.  Returns the iterated (hist ``(..., n, d)``, fut ``(..., p, d)``)."""
    zh, zf = mh_rows.transpose(-1, -2), mf_rows.transpose(-1, -2)
    for Q in rotations:
        yr = (y_obs @ Q).transpose(-1, -2)  # (..., d, m) rows per axis
        zhr = (zh @ Q).transpose(-1, -2)
        zfr = (zf @ Q).transpose(-1, -2)
        ys = on_rows("sort_rows", yr)
        zh_m, zs, ms = _qm_rows_by_rank(zhr, ys, lo, hi, w)
        zf_m = interp_rows(zs, ms, zfr)
        zh = zh_m.transpose(-1, -2) @ Q.T
        zf = zf_m.transpose(-1, -2) @ Q.T
    return zh, zf


def mbcn_reorder(margin_rows, z_fin):
    """Step 3: the margins ``(..., d, n)`` reordered to the ranks of the
    iterated data ``z_fin`` ``(..., n, d)`` -> ``(..., n, d)``."""
    return rank_reorder(margin_rows, z_fin.transpose(-1, -2)).transpose(-1, -2)


def mbcn_correct(
    y_obs,
    x_hist,
    x_fut,
    rotations,
    *,
    kinds,
    extrapolate="both",
    n_endpoints: int = 10,
    alpha: float = 0.4,
    beta: float = 0.4,
):
    """Batch-native MBCn.

    Parameters
    ----------
    y_obs : (..., m, d) observations.
    x_hist : (..., n, d) model over the calibration period.
    x_fut : (..., p, d) model over the projection period (may be
        ``x_hist`` to correct the calibration period itself).
    rotations : (R, d, d) orthogonal stack (see :func:`mbcn_rotations`),
        numpy or a tensor.
    kinds : length-d tuple of 'difference'/'ratio', the QDM margin kind per
        variable (ratio for precipitation-like variables).

    The tensors share one device: CUDA float32 runs the kernels, the CPU
    their plain versions (float64 stays float64).

    Returns
    -------
    (out_hist, out_fut) with the shapes of ``x_hist`` / ``x_fut``.
    """
    d, n, m = x_hist.shape[-1], x_hist.shape[-2], y_obs.shape[-2]
    if len(kinds) != d:
        raise ValueError(f"kinds has {len(kinds)} entries for {d} variables")
    dtype = torch.promote_types(x_hist.dtype, torch.float32)
    y_obs, x_hist, x_fut = (t.to(dtype) for t in (y_obs, x_hist, x_fut))
    rots = torch.as_tensor(rotations, dtype=dtype, device=x_hist.device)
    lo, hi, w = _rank_bracket_dev(n, m, alpha, beta, x_hist.device, dtype)
    mh_rows, mf_rows = mbcn_margins(
        y_obs, x_hist, x_fut, kinds=kinds, extrapolate=extrapolate, n_endpoints=n_endpoints
    )
    zh_fin, zf_fin = mbcn_iterate(y_obs, mh_rows, mf_rows, rots, lo, hi, w)
    return mbcn_reorder(mh_rows, zh_fin), mbcn_reorder(mf_rows, zf_fin)


def mbcn_correct_monthly(
    y_obs,
    x_hist,
    x_fut,
    months_obs,
    months_hist,
    months_fut,
    rotations,
    *,
    kinds,
    extrapolate="both",
    n_endpoints: int = 10,
):
    """Calendar-month-grouped MBCn (dependence structure often differs by
    season).

    ``months_*``: host int arrays (1..12) labelling each time step of the
    corresponding block.  Each month's subsets run through
    :func:`mbcn_correct` (the same rotation stack), and the outputs are put
    back in time order by concatenating in group order and one gather by the
    host inverse permutation."""
    months_obs = np.asarray(months_obs)
    months_hist = np.asarray(months_hist)
    months_fut = np.asarray(months_fut)
    mset = sorted(set(months_fut.tolist()) | set(months_hist.tolist()))
    missing = [m for m in mset if (m not in months_obs) or (m not in months_hist)]
    if missing:
        raise ValueError(f"months {missing} absent from the obs/hist records")

    def take(a, idx):
        return a.index_select(-2, torch.as_tensor(idx, dtype=torch.long, device=a.device))

    parts_h, parts_f, idx_h, idx_f = [], [], [], []
    for m in mset:
        so = np.nonzero(months_obs == m)[0]
        sh = np.nonzero(months_hist == m)[0]
        sf = np.nonzero(months_fut == m)[0]
        # a month in hist but absent from fut still contributes hist output;
        # feed a few dummy fut rows (hist's first steps) and discard them
        fut_empty = len(sf) == 0
        xf_m = take(x_hist, sh[: min(len(sh), 8)]) if fut_empty else take(x_fut, sf)
        oh, of = mbcn_correct(
            take(y_obs, so), take(x_hist, sh), xf_m, rotations,
            kinds=kinds, extrapolate=extrapolate, n_endpoints=n_endpoints,
        )
        parts_h.append(oh)
        idx_h.append(sh)
        if not fut_empty:
            parts_f.append(of)
            idx_f.append(sf)

    def assemble(parts, idx):
        inv = np.argsort(np.concatenate(idx), kind="stable")
        return take(torch.cat(parts, dim=-2), inv)

    return assemble(parts_h, idx_h), assemble(parts_f, idx_f)


# ----------------------------------------------------------------------
# grid runner
# ----------------------------------------------------------------------


def pack_dataset(ds, variables):
    """A Dataset of the d ``variables`` on ``(time, *spatial)`` grids ->
    (host ``(C, T, d)`` array in the input's float dtype, the first
    variable's DataArray as the output template, the spatial shape)."""
    arrs = []
    for v in variables:
        a = np.asarray(ds[v].values)
        arrs.append(a if np.issubdtype(a.dtype, np.floating) else a.astype(np.float64))
    T, spatial = arrs[0].shape[0], arrs[0].shape[1:]
    flat = np.stack([a.reshape(T, -1) for a in arrs], axis=-1)  # (T, C, d)
    return np.moveaxis(flat, 0, 1), ds[variables[0]], spatial


def valid_cells(*packed) -> np.ndarray:
    """Ids of the cells with every sample of every variable finite in every
    packed ``(C, T, d)`` block."""
    ok = np.ones(packed[0].shape[0], dtype=bool)
    for a in packed:
        ok &= np.isfinite(a).all(axis=(1, 2))
    return np.nonzero(ok)[0]


def to_device(host_block: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host ``(c, T, d)`` block on ``device``: float32 on the card, the
    input dtype on the CPU."""
    if device.type == "cuda":
        host_block = host_block.astype(np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(host_block)).to(device)


def unpack_dataset(out: np.ndarray, template, spatial, variables):
    """``(C, T, d)`` -> a Dataset of the ``variables`` on the template's grid."""
    T = out.shape[1]
    real_xr = type(template).__module__.startswith("xarray")
    das = {}
    for j, v in enumerate(variables):
        field = np.moveaxis(out[:, :, j], 0, 1).reshape(T, *spatial)
        if real_xr:  # pragma: no cover - real-xarray images
            import xarray as xr

            das[v] = xr.DataArray(field, dims=template.dims, coords=template.coords)
        else:
            from ..xlite import DataArray

            das[v] = DataArray(field, template.dims, dict(template.coords))
    if real_xr:  # pragma: no cover - real-xarray images
        import xarray as xr

        return xr.Dataset(das)
    from ..xlite import Dataset

    return Dataset(das)


def mbcn_grid(
    y_obs,
    x_hist,
    x_fut,
    *,
    variables=None,
    n_iterations: int = 20,
    kind="difference",
    extrapolate="both",
    n_endpoints: int = 10,
    random_state: int = 0,
    group=None,
    cell_chunk_size: int | None = None,
    device="cuda",
    sharding=None,
):
    """Grid-level MBCn: joint correction over every valid cell of a grid.

    Parameters
    ----------
    y_obs, x_hist, x_fut : ``xlite.Dataset`` (or real xarray Dataset) of the
        SAME d variables on ``(time, *spatial)`` grids; the three time axes
        may differ, the spatial shapes must match.
    variables : explicit variable order (default: ``y_obs``'s order).
    cell_chunk_size : cap on cells per device pass (device memory).
    device : where the cells are corrected: the card by default (float32,
        the kernels), ``"cpu"`` for the plain versions in the input's dtype.
        Without a card a CUDA device raises.
    sharding : ``parallel.cell_sharding(mesh, 3)`` (or a ``CellMesh``),
        in place of ``device``: each pass's cells are padded by cycling
        them (``np.resize``, not NaN: every shard holds real cells) to a
        multiple of the mesh axis that splits the cell axis, split into
        contiguous blocks in mesh order and corrected shard by shard, each
        on its device (``skdownscale_tpu/models/mbc.py:366-381``).

    Returns ``(hist_out, fut_out)`` Datasets on the input grids; cells with
    any non-finite sample in any variable of any input stay NaN (the
    multivariate transform has no per-component masking).
    """
    if group not in (None, "month"):
        raise ValueError(f"group must be None or 'month', got {group!r}")
    mesh, mult = None, 1
    if sharding is not None:
        mesh = sharding if isinstance(sharding, CellMesh) else sharding.mesh
        axis0 = mesh.axis_names[0] if isinstance(sharding, CellMesh) else sharding.spec[0]
        mult = int(mesh.shape[axis0]) if axis0 is not None else 1
    dev = torch.device(device) if mesh is None else mesh.devices[0]
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mbcn_grid runs on the card (device='cuda'), and torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU in the input's dtype"
        )
    variables = list(variables or y_obs.data_vars)
    d = len(variables)
    yo, _, sp_y = pack_dataset(y_obs, variables)
    xh, da_h, sp_h = pack_dataset(x_hist, variables)
    xf, da_f, sp_f = pack_dataset(x_fut, variables)
    if not (sp_y == sp_h == sp_f):
        raise ValueError(f"spatial shapes differ: {sp_y} vs {sp_h} vs {sp_f}")
    ids = valid_cells(yo, xh, xf)
    rots = mbcn_rotations(d, int(n_iterations), int(random_state))
    kinds = _kinds_tuple(kind, d)
    common = dict(kinds=kinds, extrapolate=extrapolate, n_endpoints=n_endpoints)
    if group == "month":
        from ..utils.timeindex import TimeIndex

        months = [
            np.asarray(TimeIndex.from_any(ds[variables[0]].coords["time"]).month)
            for ds in (y_obs, x_hist, x_fut)
        ]

    out_h = np.full_like(xh, np.nan)
    out_f = np.full_like(xf, np.nan)
    step = max(len(ids) if not cell_chunk_size else int(cell_chunk_size), 1)

    def correct(blocks):
        if group == "month":
            return mbcn_correct_monthly(*blocks, *months, rots, **common)
        return mbcn_correct(*blocks, rots, **common)

    for s in range(0, len(ids), step):
        sel = ids[s : s + step]
        if mult == 1:
            oh, of = correct([to_device(a[sel], dev) for a in (yo, xh, xf)])
            out_h[sel] = oh.cpu().numpy()
            out_f[sel] = of.cpu().numpy()
            continue
        # replicate cells (cycling) so every shard is populated; mesh shard
        # k corrects block k * mult // size (one block a shard on a 1-D mesh)
        fill = np.resize(np.arange(len(sel)), len(sel) + (-len(sel)) % mult)
        rows = len(fill) // mult
        local = {}
        for k, shard_dev in zip(mesh.local_shards, mesh.devices):
            b = k * mult // mesh.size
            if b not in local:
                with on_device(shard_dev):
                    local[b] = correct([to_device(a[sel[fill[b * rows:(b + 1) * rows]]], shard_dev)
                                        for a in (yo, xh, xf)])
        local = {b: (oh.cpu().numpy(), of.cpu().numpy()) for b, (oh, of) in local.items()}
        blocks = {b: o for part in gather_objects(local, mesh) for b, o in part.items()}
        out_h[sel] = np.concatenate([blocks[b][0] for b in range(mult)])[: len(sel)]
        out_f[sel] = np.concatenate([blocks[b][1] for b in range(mult)])[: len(sel)]
    return (
        unpack_dataset(out_h, da_h, sp_h, variables),
        unpack_dataset(out_f, da_f, sp_f, variables),
    )


# ----------------------------------------------------------------------
# sklearn-compatible wrapper (single cell, on ``single_cell_device``)
# ----------------------------------------------------------------------


class MBCn(SingleCellEstimator):
    """Multivariate (MBCn) bias correction, sklearn-style wrapper.

    ``fit(X, y)`` takes the model calibration block and the observations,
    both ``(n_samples, d)`` with the SAME d variables (lengths may differ),
    and ``predict(X)`` corrects a projection block jointly with the stored
    calibration data.  Column order defines variable identity.

    Parameters
    ----------
    n_iterations : rotation rounds.
    kind : 'difference' / 'ratio' (all variables) or a sequence per column.
    extrapolate, n_endpoints : QDM margin CDF options (see
        ``QuantileMappingReressor``).
    group : None (whole-series) or 'month': run the transform per calendar
        month; needs datetime-indexed inputs (a monthly-from-1950 index is
        made up for raw arrays).
    random_state : seed for the rotation stack.
    """

    _fit_attributes = ["x_hist_", "y_obs_", "rotations_", "n_features_in_"]
    # the obs record and the model calibration block may differ in length
    _allow_length_mismatch = True

    def __init__(
        self,
        n_iterations: int = 20,
        kind="difference",
        extrapolate="both",
        n_endpoints: int = 10,
        group=None,
        random_state: int = 0,
    ):
        self.n_iterations = n_iterations
        self.kind = kind
        self.extrapolate = extrapolate
        self.n_endpoints = n_endpoints
        self.group = group
        self.random_state = random_state

    def _kinds(self, d: int):
        kinds = _kinds_tuple(self.kind, d)
        if len(kinds) != d or any(k not in ("difference", "ratio") for k in kinds):
            raise ValueError(
                f"kind must be 'difference'/'ratio' (or one per {d} columns), got {self.kind!r}"
            )
        return kinds

    @staticmethod
    def _finite(xa):
        if not np.isfinite(xa).all():
            raise ValueError(
                "MBCn input X contains non-finite values; the multivariate "
                "transform has no per-component masking: drop those rows "
                "(grids: mbcn_grid masks whole cells)"
            )

    def fit(self, X, y):
        X, y = self._validate_data(X, y=y)
        xa = asarray_2d(X)
        ya = asarray_2d(y)
        self._finite(xa)
        if ya.shape[1] != xa.shape[1]:
            raise ValueError(
                f"y has {ya.shape[1]} variables but X has {xa.shape[1]}; MBCn "
                "corrects the joint distribution of the same variable set"
            )
        self._kinds(xa.shape[1])  # validate early
        if self.group not in (None, "month"):
            raise ValueError(f"group must be None or 'month', got {self.group!r}")
        self.x_hist_ = np.asarray(xa, dtype=np.float64)
        self.y_obs_ = np.asarray(ya, dtype=np.float64)
        self.rotations_ = mbcn_rotations(xa.shape[1], int(self.n_iterations), int(self.random_state))
        self._columns = list(getattr(X, "columns", range(xa.shape[1])))
        if self.group == "month":
            self._months_hist = np.asarray(self._time_index(X).month)
            self._months_obs = np.asarray(self._time_index(y).month)
        return self

    def _common(self):
        return dict(
            kinds=self._kinds(self.x_hist_.shape[1]),
            extrapolate=self.extrapolate,
            n_endpoints=self.n_endpoints,
        )

    def predict(self, X):
        self._check_is_fitted()
        X = self._validate_data(X, reset=False)
        xa = asarray_2d(X)
        self._finite(xa)
        y_obs, x_hist, x_fut = (self._cell_tensor(a) for a in (self.y_obs_, self.x_hist_, xa))
        if self.group == "month":
            _, out = mbcn_correct_monthly(
                y_obs, x_hist, x_fut,
                self._months_obs, self._months_hist, np.asarray(self._time_index(X).month),
                self.rotations_, **self._common(),
            )
        else:
            _, out = mbcn_correct(y_obs, x_hist, x_fut, self.rotations_, **self._common())
        out = out.cpu().numpy()
        index = getattr(X, "index", None)
        if index is not None and hasattr(X, "columns"):
            import pandas as pd

            return pd.DataFrame(out, index=index, columns=self._columns)
        return out

    def transform(self, X=None):
        """Correct the calibration block itself (X ignored if given)."""
        self._check_is_fitted()
        x_hist = self._cell_tensor(self.x_hist_)
        out, _ = mbcn_correct(
            self._cell_tensor(self.y_obs_), x_hist, x_hist, self.rotations_, **self._common()
        )
        return out.cpu().numpy()
