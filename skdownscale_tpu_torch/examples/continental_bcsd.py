"""Continental-scale BCSD in one device pass.

``PointWiseDownscaler(BcsdTemperature(return_anoms=False))`` fits and
predicts a square grid of 40 years of monthly float32 data with one ocean
cell.  Below ``models.batched.STREAMING_CELL_THRESHOLD`` valid cells
(2,000,000) the runner takes the dense path; from there on, the streaming
formulation (a lazy fit, then a group-chunked predict).  The example prints
the route it took, the wall of fit and predict and their split, and with
``--check-cells K`` holds K cells spread over the grid against the CPU
float64 path.

``--zarr [DIR]`` runs the production loop instead: the grid pair is read
from a zarr v3 store (written first if ``DIR`` does not exist; by default
under ``--out``), the corrected grid is written beside it, and the
``PipelineReport`` gives the read / pack / h2d / device / write split
(``parallel/pipeline.py``).

    python -m skdownscale_tpu_torch.examples.continental_bcsd [--device cpu]
        [--n-side 256] [--check-cells K] [--zarr [DIR]]
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..utils.device import resolve
from .utils import parser

N_MONTHS = 480


def make_grid(n_side: int, seed: int = 0):
    """The (time, y, x) float32 GCM and obs grids: a seasonal cycle, noise
    and a +1.5 K bias, with cell (0, 0) an ocean cell; drawn in float32 so
    that the host holds two grids, not their float64 forms."""
    import pandas as pd

    index = pd.date_range("1970-01-01", periods=N_MONTHS, freq="MS")
    rng = np.random.default_rng(seed)
    seasonal = (8.0 * np.sin(2 * np.pi * (index.month.to_numpy() - 1) / 12)).astype(np.float32)
    shape = (N_MONTHS, n_side, n_side)
    X = rng.standard_normal(shape, dtype=np.float32)
    X *= 2.0
    X += (283.0 + 1.5 + seasonal)[:, None, None]
    y = rng.standard_normal(shape, dtype=np.float32)
    y *= 1.8
    y += (282.0 + seasonal)[:, None, None]
    X[:, 0, 0] = np.nan  # an ocean cell
    return index, X, y


def _write_store(path, n_side, seed=0):
    """The grid pair as a zarr v3 group, chunked in bands of rows (as a
    continental store is), with a ``time`` member marked as datetimes."""
    from skdownscale_tpu_torch.utils import zarrlite

    index, X, y = make_grid(n_side, seed)
    t = np.asarray(index, dtype="datetime64[ns]").view(np.int64)
    cy = max(n_side // 4, 1)
    zarrlite.save_group(path, {"gcm": X, "obs": y, "time": t},
                        chunks={"gcm": (N_MONTHS, cy, n_side), "obs": (N_MONTHS, cy, n_side),
                                "time": (N_MONTHS,)})
    zarrlite.save_array(f"{path}/time", t, attrs={"kind": "datetime64[ns]"})


def _zarr(args, dev) -> dict:
    from skdownscale_tpu_torch import BcsdTemperature
    from skdownscale_tpu_torch.parallel.pipeline import run_pointwise_pipeline
    from skdownscale_tpu_torch.utils import zarrlite

    store = args.zarr or os.path.join(args.out, f"continental_{args.n_side}.zarr")
    if not os.path.exists(store):
        print(f"writing synthetic store {store} ...")
        os.makedirs(os.path.dirname(os.path.abspath(store)), exist_ok=True)
        _write_store(store, args.n_side)
    out_store = store.rstrip("/") + ".corrected"
    rep = run_pointwise_pipeline(store, out_store, BcsdTemperature(return_anoms=False),
                                 cell_chunk=131072, zarr_format=3, compressor="blosc",
                                 checksum=True, device=dev)
    print(f"store -> device -> store ({store} -> {out_store}):")
    print("  " + rep.summary())
    v = np.asarray(zarrlite.open_group(out_store)["corrected"])
    obs = np.asarray(zarrlite.open_group(store)["obs"])
    res = {"cells": float(rep.n_cells), "wall_s": rep.wall_s, "cells_per_s": rep.cells_per_sec,
           "read_s": rep.read_s, "pack_s": rep.pack_s, "h2d_s": rep.put_s, "device_s": rep.device_s,
           "write_s": rep.write_s, "ocean_nan": float(np.isnan(v[:, 0, 0]).all()),
           "corrected_mean": float(np.nanmean(v)), "obs_mean": float(np.nanmean(obs))}
    print(f"  ocean cell NaN-preserved: {bool(res['ocean_nan'])}")
    print(f"  bias removed: corrected mean {res['corrected_mean']:.3f} vs obs {res['obs_mean']:.3f}")
    return res


def check_cells(X, y, v, index, k: int) -> dict:
    """``k`` valid cells spread over the grid through the same estimator on
    the CPU in float64, against the run's output ``v``: the 99.9th
    percentile, the share above 1e-3 K and the largest |difference|."""
    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.xlite import DataArray

    T = X.shape[0]
    valid = np.flatnonzero(np.isfinite(X[0].reshape(-1)))
    ids = valid[np.linspace(0, len(valid) - 1, k).astype(np.int64)]

    def cells(a):
        return DataArray(a.reshape(T, -1)[:, ids].astype(np.float64), ("time", "cell"),
                         {"time": index, "cell": np.arange(k)})

    ref = sdt.PointWiseDownscaler(sdt.BcsdTemperature(return_anoms=False), device="cpu")
    ref = np.asarray(ref.fit(cells(X), cells(y)).predict(cells(X)).values)
    d = np.abs(v.reshape(T, -1)[:, ids] - ref)
    return {"check_p999": float(np.quantile(d, 0.999)), "check_share": float(np.mean(d > 1e-3)),
            "check_max": float(d.max())}


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n-side", type=int, default=256, help="grid side: n_side**2 cells (default 256)")
    p.add_argument("--check-cells", type=int, default=0,
                   help="cells held against the CPU float64 path (default 0: none)")
    p.add_argument("--zarr", nargs="?", const="", default=None, metavar="DIR",
                   help="run the store -> device -> store pipeline on the zarr store DIR")
    args = p.parse_args(argv)
    dev = resolve(args.device, "continental_bcsd")
    if args.zarr is not None:
        return _zarr(args, dev)

    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.models.batched import STREAMING_CELL_THRESHOLD
    from skdownscale_tpu_torch.models.bcsd import BcsdLazyState
    from skdownscale_tpu_torch.utils.profiling import StageTimer
    from skdownscale_tpu_torch.xlite import DataArray

    n = args.n_side
    index, X, y = make_grid(n)
    coords = {"time": index, "y": np.arange(n), "x": np.arange(n)}
    Xda = DataArray(X, ("time", "y", "x"), coords)
    yda = DataArray(y, ("time", "y", "x"), coords)

    d = sdt.PointWiseDownscaler(sdt.BcsdTemperature(return_anoms=False), device=dev)
    timer = StageTimer()
    sync = torch.empty(0, device=dev)
    t0 = time.perf_counter()
    with timer.stage("fit", sync=sync):
        d.fit(Xda, yda)
    with timer.stage("predict", sync=sync):
        out = d.predict(Xda)
    wall = time.perf_counter() - t0
    v = np.asarray(out.values)
    cells = n * n
    route = "streaming" if isinstance(d._state[0], BcsdLazyState) else "dense"
    res = {"cells": float(cells), "wall_s": wall, "cells_per_s": cells / wall,
           "fit_s": timer.totals["fit"], "predict_s": timer.totals["predict"],
           "streaming": float(route == "streaming"), "ocean_nan": float(np.isnan(v[:, 0, 0]).all()),
           "corrected_mean": float(np.nanmean(v)), "obs_mean": float(np.mean(y, dtype=np.float64))}
    print(f"{cells:,} cells fit+predict in {wall:.2f}s ({res['cells_per_s']:,.0f} cells/s, incl. host "
          f"packing) on {dev}: the {route} route ({cells - 1:,} valid cells; streaming from "
          f"{STREAMING_CELL_THRESHOLD:,}); fit {res['fit_s']:.2f}s, predict {res['predict_s']:.2f}s")
    print(f"ocean cell NaN-preserved: {bool(res['ocean_nan'])}")
    print(f"bias removed: corrected mean {res['corrected_mean']:.3f} vs obs {res['obs_mean']:.3f}")
    if args.check_cells:
        res.update(check_cells(X, y, v, index, args.check_cells))
        print(f"{args.check_cells} cells vs CPU float64: p99.9 |diff| {res['check_p999']:.3g} K, share "
              f"above 1e-3 K {res['check_share']:.3g}, max {res['check_max']:.3g} K")
    return res


if __name__ == "__main__":
    main()
