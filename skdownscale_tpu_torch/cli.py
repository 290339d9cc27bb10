"""BCSD batch runner: ``python -m skdownscale_tpu_torch.cli``.

The port's counterpart of ``scripts/run_bcsd.py``, with the same arguments
plus ``--device``: it reads numpy ``.npz`` grids (or makes a synthetic demo
workload), fits and predicts BCSD over every cell of the grid with
``PointWiseDownscaler`` on the device (the card unless ``--device cpu``),
and writes the corrected grid and a JSON line of timings.  With
``--daily-obs`` it also writes the temporally disaggregated daily grid
(:func:`.utils.disagg.bcsd_disaggregator`).

Input format (``--obs`` / ``--ref`` / ``--predict`` / ``--daily-obs``):
    data  : float array (time, *spatial)
    time  : datetime64 array

Usage:
    python -m skdownscale_tpu_torch.cli --demo --kind temperature --out out.npz
    python -m skdownscale_tpu_torch.cli --obs obs.npz --ref ref.npz \\
        --predict fut.npz --kind precipitation --out corrected.npz
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .examples.utils import get_sample_grid  # the demo workload


def load_grid(path):
    import pandas as pd

    from .xlite import DataArray

    with np.load(path) as z:
        data = z["data"]
        index = pd.DatetimeIndex(z["time"])
    spatial = {f"s{i}": np.arange(n) for i, n in enumerate(data.shape[1:])}
    dims = ("time", *spatial.keys())
    return DataArray(data, dims, {"time": index, **spatial})


def demo_grids():
    gcm, obs = get_sample_grid(ny=20, nx=20, years=20)
    return obs, gcm, gcm


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--obs", help="observed training grid (.npz)")
    p.add_argument("--ref", help="reference-period model grid (.npz)")
    p.add_argument("--predict", help="grid to bias-correct (.npz)")
    p.add_argument("--kind", choices=["temperature", "precipitation"], default="temperature")
    p.add_argument("--no-anoms", action="store_true", help="return absolute values")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--demo", action="store_true", help="run on a synthetic demo grid")
    p.add_argument(
        "--daily-obs",
        help="daily observed grid (.npz): also write the temporally"
        " disaggregated daily output (<out>.daily.npz)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device of the fit, predict and disaggregation (default: cuda; "
        "cpu keeps the input dtype)",
    )
    args = p.parse_args(argv)
    if args.daily_obs and not args.no_anoms:
        p.error("--daily-obs requires --no-anoms (disaggregate absolute values)")

    from . import BcsdPrecipitation, BcsdTemperature, PointWiseDownscaler
    from .utils.device import resolve

    device = resolve(args.device, "the BCSD runner")
    if args.demo:
        obs, ref, pred = demo_grids()
    else:
        if not (args.obs and args.ref and args.predict):
            p.error("--obs/--ref/--predict are required without --demo")
        obs, ref, pred = load_grid(args.obs), load_grid(args.ref), load_grid(args.predict)

    cls = BcsdTemperature if args.kind == "temperature" else BcsdPrecipitation
    model = cls(return_anoms=not args.no_anoms)
    d = PointWiseDownscaler(model, device=device)

    t0 = time.perf_counter()
    d.fit(ref, obs)
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = d.predict(pred)
    t_pred = time.perf_counter() - t0

    n_cells = int(np.prod(out.values.shape[1:]))
    print(
        json.dumps(
            {
                "cells": n_cells,
                "time_steps": out.values.shape[0],
                "fit_s": round(t_fit, 3),
                "predict_s": round(t_pred, 3),
                "cells_per_sec": round(n_cells / (t_fit + t_pred), 1),
            }
        )
    )
    np.savez(
        args.out,
        data=np.asarray(out.values),
        time=np.asarray(pred.coords["time"]).astype("datetime64[ns]"),
    )
    print(f"wrote {args.out}")

    if args.daily_obs:
        from .utils.disagg import bcsd_disaggregator, daily_index_for_months

        obs_daily = load_grid(args.daily_obs)
        t0 = time.perf_counter()
        daily = bcsd_disaggregator(out, obs_daily, kind=args.kind, device=device)
        daily_vals = np.asarray(daily.data)
        t_disagg = time.perf_counter() - t0
        daily_path = args.out + ".daily.npz"
        np.savez(
            daily_path,
            data=daily_vals,
            time=np.asarray(
                daily_index_for_months(out.coords["time"])
            ).astype("datetime64[ns]"),
        )
        print(json.dumps({"disagg_s": round(t_disagg, 3), "daily_steps": daily_vals.shape[0]}))
        print(f"wrote {daily_path}")


if __name__ == "__main__":
    main()
