"""Sharded-grid example: BCSD over a cell mesh, and QDM over a
(cells, time) mesh.

The mesh is ``cell_mesh()`` over the process's CUDA devices (``--device
cpu``: one CPU shard).  The cell axis is the only parallel axis of the BCSD
run, and the fitted state stays with each shard's cells.  Then QDM on a
2-D (cells, time) mesh, for records too long for one device: each cell
row's time shards are gathered onto the row's first device for the
full-row fit and predict, and the result must be bitwise equal to the
single-device run.  A mesh of an odd number of devices takes each twice
for the time axis (repeated devices share a card and run one after
another).

    python -m skdownscale_tpu_torch.examples.sharded_grid [--device cpu] [--side 16] [--years 30]
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..utils.device import resolve
from .global_models_example import mesh_of
from .utils import parser, tensor


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--side", type=int, default=16, help="grid side (default 16)")
    p.add_argument("--years", type=int, default=30, help="years of monthly data (default 30)")
    args = p.parse_args(argv)
    dev = resolve(args.device, "sharded_grid")

    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.models.quantile import edcdfm_predict, qmr_fit
    from skdownscale_tpu_torch.parallel import shard_cells_time, time_cell_mesh
    from skdownscale_tpu_torch.xlite import DataArray

    mesh = mesh_of(dev)
    print(f"mesh: {mesh.size} x {mesh.devices[0].type} devices")

    rng = np.random.default_rng(0)
    idx = pd.date_range("1980-01-01", periods=12 * args.years, freq="MS")
    T, ny, nx = len(idx), args.side, args.side
    seas = 10 * np.sin(2 * np.pi * (idx.month.to_numpy() - 1) / 12)[:, None, None]
    gcm = 284 + seas + rng.normal(0, 2, (T, ny, nx)) + 1.5
    obs = 283 + seas + rng.normal(0, 1.8, (T, ny, nx))
    coords = {"time": idx, "y": np.arange(ny), "x": np.arange(nx)}
    X = DataArray(gcm, ("time", "y", "x"), coords)
    y = DataArray(obs, ("time", "y", "x"), coords)

    d = sdt.PointWiseDownscaler(sdt.BcsdTemperature(return_anoms=False), sharding=mesh)
    d.fit(X, y)
    # the fitted state stays on the shards' devices
    state_devices = sorted({str(t.device) for chunk in d._state for s in chunk if s is not None
                            for t in s if isinstance(t, torch.Tensor)})
    print(f"state shards on: {state_devices}")
    out = d.predict(X)
    res = {"corrected_mean": float(np.nanmean(out.values)), "obs_mean": float(obs.mean()),
           "raw_mean": float(gcm.mean())}
    print(f"corrected mean {res['corrected_mean']:.2f} (obs {res['obs_mean']:.2f}, "
          f"raw {res['raw_mean']:.2f})")

    # time-axis sharding: a (cells, time) mesh bounds each device's input
    devices = mesh.devices if len(mesh.devices) % 2 == 0 else mesh.devices * 2
    tmesh = time_cell_mesh(devices, time_shards=2)
    rows = tmesh.shape["cells"]
    C = 2 * rows
    xf = 284 + rng.normal(0, 2, (C, T))
    yf = 283 + rng.normal(0, 1.8, (C, T))

    def qdm(a, b):
        return edcdfm_predict(qmr_fit(a, b, extrapolate="both"), a,
                              kind="difference", extrapolate="both")

    xs, ys = (shard_cells_time(a, tmesh)[0].gather_rows() for a in (xf, yf))
    got = xs.map(qdm, ys).gather()
    single = qdm(*(tensor(a, mesh.devices[0]) for a in (xf, yf)))
    res["time_sharded_bitwise"] = float(np.array_equal(got, single.cpu().numpy()))
    print(f"time-sharded QDM on a {rows}x2 (cells, time) mesh: bitwise == single-device: "
          f"{bool(res['time_sharded_bitwise'])}")
    return res


if __name__ == "__main__":
    main()
