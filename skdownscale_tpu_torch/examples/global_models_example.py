"""Global (pooled) models example: one correction fit across the whole grid.

The pointwise models fit each cell alone; the pooled fits reduce across the
cell mesh.  The linear model all-reduces its sufficient statistics, and the
quantile mapper merges the shards' order-statistic sketches with one
all-gather.  The mesh is ``cell_mesh()`` over the process's CUDA devices
(``--device cpu``: one CPU shard).

    python -m skdownscale_tpu_torch.examples.global_models_example [--device cpu]
        [--days 3650] [--ny 24] [--nx 32]
"""

from __future__ import annotations

import numpy as np

from ..utils.device import resolve
from .utils import parser


def mesh_of(dev):
    """The example's cell mesh: every CUDA device of the process for
    ``cuda``, else the one device asked for."""
    import torch

    from skdownscale_tpu_torch.parallel import cell_mesh

    return cell_mesh() if dev == torch.device("cuda") else cell_mesh([dev])


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--days", type=int, default=3650, help="days of daily data (default 3650)")
    p.add_argument("--ny", type=int, default=24, help="grid rows (default 24)")
    p.add_argument("--nx", type=int, default=32, help="grid columns (default 32)")
    args = p.parse_args(argv)
    dev = resolve(args.device, "global_models_example")

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.xlite import DataArray

    mesh = mesh_of(dev)
    print(f"mesh: {mesh.size} x {mesh.devices[0].type} devices")

    rng = np.random.default_rng(3)
    T, ny, nx = args.days, args.ny, args.nx
    doy = np.arange(T) % 365
    seas = 9 * np.sin(2 * np.pi * doy / 365.25)
    obs = 284 + seas[:, None, None] + rng.normal(0, 3, (T, ny, nx))
    gcm = obs * 1.15 - 42.0  # systematic multiplicative + additive bias
    obs[:, 0, :4] = np.nan  # ocean strip
    gcm[:, 0, :4] = np.nan

    X = DataArray(gcm, dims=("time", "y", "x"))
    Y = DataArray(obs, dims=("time", "y", "x"))

    # pooled quantile mapping: the sketch fit over the mesh
    gd = sdt.GlobalDownscaler(sdt.GlobalQuantileMapper(n_quantiles=1024, device=dev), sharding=mesh)
    gd.fit(X, Y)
    out = np.asarray(gd.transform(X).data)  # (y, x, time)
    res = {"bias_before": float(np.nanmean(gcm - obs)),
           "bias_after": float(np.nanmean(np.moveaxis(out, -1, 0) - obs))}
    print(f"pooled QM   bias: {res['bias_before']:+7.3f} -> {res['bias_after']:+7.3f}")

    # pooled fixed-effects linear model: shared slope, per-cell intercepts
    C = ny * nx
    Xf = np.moveaxis(gcm, 0, -1).reshape(C, T)[..., None]
    yf = np.moveaxis(obs, 0, -1).reshape(C, T)
    glr = sdt.GlobalDownscaler(sdt.GlobalLinearRegressor(cell_intercepts=True, device=dev), sharding=mesh)
    glr.fit(Xf, yf)
    pred = np.asarray(glr.predict(Xf))
    vv = np.isfinite(yf)
    res["rmse"] = float(np.sqrt(np.mean((pred[vv] - yf[vv]) ** 2)))
    res["slope"] = float(glr._model.state_.coef[0])
    print(f"pooled FE linear rmse: {res['rmse']:.4f} (shared slope {res['slope']:.4f}, true {1 / 1.15:.4f})")
    return res


if __name__ == "__main__":
    main()
