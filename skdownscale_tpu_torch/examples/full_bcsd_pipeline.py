"""The complete BCSD chain: bias correction, then spatial, then temporal
disaggregation.

The reference implements only the bias-correction step (its command line
hands the disaggregation halves to an external package); this runs all
three on a synthetic continental-like workload:

1. **bias-correct** coarse monthly GCM output against coarse monthly obs:
   ``PointWiseDownscaler(BcsdTemperature(return_anoms=True))``, every valid
   cell at once; the output is monthly anomalies;
2. **spatially disaggregate** the coarse anomalies onto the grid ``--scale``
   times finer and add the fine observed monthly climatology
   (``utils.disagg.spatial_disaggregate``, a batched bilinear resize);
3. **temporally disaggregate** the fine monthly fields to daily with the
   fine daily obs' within-month patterns, conserving each month's mean
   (``utils.disagg.temporal_disaggregate``).

Saves a 3-panel figure (coarse anomaly, fine monthly, fine daily) to
``--out``/full_bcsd_pipeline.png.

    python -m skdownscale_tpu_torch.examples.full_bcsd_pipeline [--device cpu]
        [--ny 12] [--nx 16] [--years 20]
"""

from __future__ import annotations

import numpy as np

from ..utils.device import resolve
from .utils import parser, pyplot, save


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--ny", type=int, default=12, help="coarse grid rows (default 12)")
    p.add_argument("--nx", type=int, default=16, help="coarse grid columns (default 16)")
    p.add_argument("--scale", type=int, default=4, help="fine cells a coarse cell's side (default 4)")
    p.add_argument("--years", type=int, default=20,
                   help="years of monthly data; the fine daily obs cover the first ten (default 20)")
    args = p.parse_args(argv)
    dev = resolve(args.device, "full_bcsd_pipeline")

    import pandas as pd

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.utils.disagg import spatial_disaggregate, temporal_disaggregate
    from skdownscale_tpu_torch.xlite import DataArray

    rng = np.random.default_rng(4)
    ny, nx, scale = args.ny, args.nx, args.scale
    NY, NX = ny * scale, nx * scale
    mi = pd.date_range("1980-01-01", periods=12 * args.years, freq="MS")
    oi = pd.date_range("1980-01-01", f"{1980 + min(10, args.years) - 1}-12-31", freq="D")

    # synthetic truth: seasonal cycle + smooth topographic gradient
    seas_m = 10 * np.sin(2 * np.pi * (np.asarray(mi.month) - 1) / 12)
    topo_f = 4 * np.sin(np.linspace(0, np.pi, NY))[:, None] * np.cos(
        np.linspace(0, 2 * np.pi, NX)
    )[None, :]
    topo_c = topo_f.reshape(ny, scale, nx, scale).mean(axis=(1, 3))

    def coarse(b):
        return 284 + seas_m[:, None, None] + topo_c + rng.normal(0, 2, (len(mi), ny, nx)) + b

    gcm_c, obs_c = coarse(1.8), coarse(0.0)
    gcm_c[:, :2, :3] = np.nan  # ocean corner
    obs_c[:, :2, :3] = np.nan
    coords = {"time": mi, "y": np.arange(ny), "x": np.arange(nx)}
    gcm_da = DataArray(gcm_c, ("time", "y", "x"), coords)
    obs_da = DataArray(obs_c, ("time", "y", "x"), coords)

    # fine daily obs (for the fine climatology and the daily patterns)
    doy = np.asarray(oi.dayofyear)
    obs_fd = (
        284
        + 10 * np.sin(2 * np.pi * doy / 365.25)[:, None, None]
        + topo_f
        + rng.normal(0, 2.5, (len(oi), NY, NX))
    )

    # --- 1. bias correction (anomaly output) over the coarse grid --------
    d = sdt.PointWiseDownscaler(sdt.BcsdTemperature(return_anoms=True), device=dev)
    d.fit(gcm_da, obs_da)
    anoms = np.asarray(d.predict(gcm_da).values)  # (T, ny, nx), NaN ocean
    res = {"mean_abs_anomaly": float(np.nanmean(np.abs(anoms)))}
    print(f"1. bias correction: coarse anomalies {anoms.shape}, "
          f"mean |anom| {res['mean_abs_anomaly']:.2f} K")

    # --- 2. spatial disaggregation: coarse anoms -> fine grid + climo ----
    month_labels = np.asarray(mi.month) - 1
    fine_climo = np.stack(
        [obs_fd[np.asarray(oi.month) == m + 1].mean(axis=0) for m in range(12)]
    )
    fine_monthly = spatial_disaggregate(
        anoms, fine_climo, month_labels, kind="temperature", nan_aware=True, device=dev
    ).cpu().numpy()
    # coastal fine cells take renormalized valid-neighbour means; fully-ocean
    # fine cells stay NaN -> fill with climatology for the daily step
    fine_monthly = np.where(np.isfinite(fine_monthly), fine_monthly, fine_climo[month_labels])
    res["fine_monthly_mean"] = float(np.mean(fine_monthly))
    print(f"2. spatial disaggregation: {anoms.shape[1:]} -> {fine_monthly.shape[1:]} "
          f"(bilinear x{scale} + fine monthly climatology)")

    # --- 3. temporal disaggregation: fine monthly -> fine daily ----------
    daily = temporal_disaggregate(fine_monthly, mi, obs_fd, oi, kind="temperature",
                                  device=dev).cpu().numpy()
    out_index = pd.date_range(mi[0], mi[-1] + pd.offsets.MonthEnd(0), freq="D")
    key = np.asarray(out_index.year) * 100 + np.asarray(out_index.month)
    res["conservation_error"] = max(
        float(np.max(np.abs(daily[key == k].mean(axis=0) - fine_monthly[i])))
        for i, k in enumerate(np.unique(key)[:24])
    )
    res["daily_steps"] = float(daily.shape[0])
    print(f"3. temporal disaggregation: {daily.shape[0]} daily steps on the fine "
          f"grid; monthly-mean conservation error {res['conservation_error']:.1e} K")

    plt = pyplot(args.out)
    if plt is None:
        return res
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    im0 = axes[0].imshow(anoms[6], cmap="RdBu_r", vmin=-3, vmax=3, origin="lower")
    axes[0].set_title(f"coarse anomaly {anoms.shape[1:]} (K)")
    fig.colorbar(im0, ax=axes[0], shrink=0.8)
    im1 = axes[1].imshow(fine_monthly[6], cmap="viridis", origin="lower")
    axes[1].set_title(f"fine monthly {fine_monthly.shape[1:]} (K)")
    fig.colorbar(im1, ax=axes[1], shrink=0.8)
    im2 = axes[2].imshow(daily[min(190, len(daily) - 1)], cmap="viridis", origin="lower")
    axes[2].set_title("fine daily snapshot (K)")
    fig.colorbar(im2, ax=axes[2], shrink=0.8)
    print(f"saved pipeline figure -> {save(fig, args.out, 'full_bcsd_pipeline.png')}")
    return res


if __name__ == "__main__":
    main()
