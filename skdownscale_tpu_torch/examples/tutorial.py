"""Tutorial: an end-to-end downscaling walkthrough (the script form of the
reference's talk notebook and tutorials).

1. load daily GCM-like training data and observations (synthetic stand-ins,
   ``examples.utils``);
2. fit a panel of models on the single-cell API;
3. compare them by skill and the reference's Q-Q probability plots
   (``tutorial_probplots.png``);
4. scale BCSD over a (time, y, x) grid with ``PointWiseDownscaler`` (NaN
   ocean cells stay NaN) and map its bias (``tutorial_bias_map.png``);
5. correct wind with ``ZScoreRegressor`` (two diagnostic figures);
6. disaggregate the corrected monthly grid to daily with
   ``bcsd_disaggregator`` (``tutorial_disagg.png``);
7. correct tmax and pr jointly with ``MBCn``, checked by the energy
   distance.

Figures go to ``--out`` when matplotlib is installed.

    python -m skdownscale_tpu_torch.examples.tutorial [--device cpu] [--years 30] [--side 12]
"""

from __future__ import annotations

import numpy as np

from ..utils.device import resolve
from .mbcn_example import make_series
from .utils import (
    get_sample_data,
    get_sample_grid,
    on_device,
    parser,
    prob_plots,
    pyplot,
    save,
    tensor,
    zscore_correction_plot,
    zscore_ds_plot,
)


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--years", type=int, default=30,
                   help="years of each daily sample series; two thirds fit, one evaluates (default 30)")
    p.add_argument("--side", type=int, default=12, help="side of the grid of steps 4 and 6 (default 12)")
    args = p.parse_args(argv)
    dev = resolve(args.device, "tutorial")

    import pandas as pd

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.utils import metrics
    from skdownscale_tpu_torch.utils.disagg import bcsd_disaggregator
    from skdownscale_tpu_torch.xlite import DataArray

    plt = pyplot(args.out)
    res = {}

    # 1. data: daily temperature, a biased and drifting GCM series and the
    #    observations at the same place
    end = str(1980 + args.years - 1)
    training = get_sample_data("training")[:end]
    targets = get_sample_data("targets")[:end]
    split = f"{1980 + (2 * args.years) // 3}-01-01"  # both halves hold this day, as in the reference
    X_hist, X_fut = training[:split], training[split:]
    y_hist, y_fut = targets[:split], targets[split:]
    res["raw_bias"] = float(X_fut["tmax"].mean() - y_fut["tmax"].mean())
    print(f"training {X_hist.shape}, evaluation {X_fut.shape}")
    print(f"raw GCM bias over evaluation period: {res['raw_bias']:+.2f} K")

    # 2. a panel of models on the sklearn-style fit / predict API
    models = {
        "BCSD: BcsdTemperature": sdt.BcsdTemperature(return_anoms=False),
        "QDM: EquidistantCdfMatcher": sdt.EquidistantCdfMatcher(kind="difference", extrapolate="both"),
        "QM: QuantileMappingReressor": sdt.QuantileMappingReressor(extrapolate="both"),
        "ZScore: ZScoreRegressor": sdt.ZScoreRegressor(window_width=31),
    }
    preds = {}
    obs = y_fut["tmax"].to_numpy()
    print("\nmodel skill over the held-out years:")
    for name, model in models.items():
        on_device(model, dev)
        model.fit(X_hist, y_hist["tmax"])
        yh = np.asarray(model.predict(X_fut)).reshape(-1)
        preds[name] = yh
        ok = np.isfinite(yh) & np.isfinite(obs)
        o, h = tensor(obs[ok], dev), tensor(yh[ok], dev)
        short = name.split(":")[0]
        res[f"{short}_bias"] = float(yh[ok].mean() - obs[ok].mean())
        res[f"{short}_rmse"] = float(metrics.rmse(o, h))
        res[f"{short}_r2"] = float(metrics.r2(o, h))
        print(f"  {name:32s} bias {res[f'{short}_bias']:+6.2f} K   rmse {res[f'{short}_rmse']:5.2f}   "
              f"r2 {res[f'{short}_r2']:.3f}")

    # 3. the reference's Q-Q probability plots
    if plt is not None:
        fig = prob_plots(X_fut["tmax"].to_numpy(), obs,
                         {k: np.nan_to_num(v, nan=np.nanmean(v)) for k, v in preds.items()}, shape=(2, 2))
        print(f"\nsaved Q-Q probability plots -> {save(fig, args.out, 'tutorial_probplots.png')}")

    # 4. the same correction over a grid: every valid cell at once, ocean
    #    cells stay NaN
    gcm, obs_grid = get_sample_grid(ny=args.side, nx=args.side, years=10)
    d = sdt.PointWiseDownscaler(sdt.BcsdTemperature(return_anoms=False), device=dev)
    d.fit(gcm, obs_grid)
    out = d.predict(gcm)
    v = np.asarray(out.values)
    raw_bias = np.asarray(gcm.values).mean(axis=0) - np.asarray(obs_grid.values).mean(axis=0)
    cor_bias = v.mean(axis=0) - np.asarray(obs_grid.values).mean(axis=0)
    res.update(grid_raw_abs_bias=float(np.nanmean(np.abs(raw_bias))),
               grid_corrected_abs_bias=float(np.nanmean(np.abs(cor_bias))),
               grid_ocean_nan=float(np.isnan(v[:, :, :2]).all()))
    print(f"grid: raw |bias| {res['grid_raw_abs_bias']:.2f} K -> corrected "
          f"{res['grid_corrected_abs_bias']:.2f} K; ocean NaN preserved: {bool(res['grid_ocean_nan'])}")
    if plt is not None:
        fig, axes = plt.subplots(1, 2, figsize=(9, 4), sharey=True)
        for ax, (title, field) in zip(axes, [("raw GCM bias (K)", raw_bias), ("after BCSD (K)", cor_bias)]):
            im = ax.imshow(field, cmap="RdBu_r", vmin=-2, vmax=2, origin="lower")
            ax.set_title(title)
        fig.colorbar(im, ax=axes, shrink=0.8)
        print(f"saved bias maps -> {save(fig, args.out, 'tutorial_bias_map.png')}")

    # 5. z-score wind correction and the reference's two diagnostic figures
    n = args.years * 365
    hist = get_sample_data("wind-hist")[:n]
    wobs = get_sample_data("wind-obs")[:n]
    rcp = get_sample_data("wind-rcp")[:n]
    z = on_device(sdt.ZScoreRegressor(), dev)
    z.fit(hist, wobs)
    zout = z.predict(rcp)
    res["zscore_corrected_mean"] = float(np.nanmean(np.asarray(zout)))  # NaN where a window is short
    res["zscore_rcp_mean"] = float(rcp["uas"].mean())
    print(f"z-score wind: future mean {res['zscore_rcp_mean']:.3f} -> corrected "
          f"{res['zscore_corrected_mean']:.3f} m/s (obs {float(wobs['uas'].mean()):.3f})")
    if plt is not None:
        p1 = save(zscore_ds_plot(hist, wobs, rcp, zout), args.out, "tutorial_zscore_series.png")
        p2 = save(zscore_correction_plot(z), args.out, "tutorial_zscore_gaussians.png")
        print(f"saved z-score diagnostics -> {p1}, {p2}")

    # 6. monthly -> daily: each corrected monthly value spread over its days
    #    with the obs daily climatology, every monthly mean kept exactly
    oi = pd.date_range("1990-01-01", "1994-12-31", freq="D")
    doy = np.asarray(oi.dayofyear)
    rng = np.random.default_rng(1)
    obs_daily = (283 + 10 * np.sin(2 * np.pi * doy / 365.25)[:, None, None]
                 + rng.normal(0, 2, (len(oi), args.side, args.side)))
    obs_daily_da = DataArray(obs_daily, ("time", "y", "x"),
                             {"time": oi, "y": np.arange(args.side), "x": np.arange(args.side)})
    daily = bcsd_disaggregator(out, obs_daily_da, kind="temperature", device=dev)
    dvals = np.asarray(daily.data)
    dtime = daily.coords["time"]
    key = np.asarray(dtime.year) * 100 + np.asarray(dtime.month)
    mvals = np.asarray(out.values)
    res["disagg_conservation_error"] = max(
        float(np.nanmax(np.abs(dvals[key == k].mean(axis=0) - mvals[i])))
        for i, k in enumerate(np.unique(key))
    )
    print(f"disaggregated {dvals.shape[0]} daily steps; max monthly-mean conservation error "
          f"{res['disagg_conservation_error']:.2e} K")
    if plt is not None:
        c = args.side // 2
        fig, ax = plt.subplots(figsize=(9, 3.2))
        ax.plot(np.asarray(dtime)[:730], dvals[:730, c, c], lw=0.6, label="daily (disaggregated)")
        ax.step(np.asarray(out.coords["time"])[:24], mvals[:24, c, c], where="post", lw=1.8,
                color="C1", label="monthly (bias-corrected)")
        ax.set_ylabel("K")
        ax.legend(loc="upper right")
        print(f"saved disaggregation figure -> {save(fig, args.out, 'tutorial_disagg.png')}")

    # 7. multivariate: tmax and pr corrected jointly by MBCn
    mb_rng = np.random.default_rng(7)
    years = min(20, args.years)

    def period(start):
        return pd.date_range(f"{start}-01-01", f"{start + years - 1}-12-31", freq="D")

    obs_tp = make_series(mb_rng, period(1980), -0.6, 0.0, 2.0)
    hist_tp = make_series(mb_rng, period(1980), -0.1, 2.0, 3.0)
    fut_tp = make_series(mb_rng, period(2050), -0.1, 2.8, 3.2)
    mb = on_device(sdt.MBCn(n_iterations=25, kind=("difference", "ratio"), random_state=0), dev)
    corrected_tp = mb.fit(hist_tp, obs_tp).predict(fut_tp)
    for name, df in [("obs", obs_tp), ("raw future", fut_tp), ("MBCn future", corrected_tp)]:
        c = float(np.corrcoef(df["tmax"], df["pr"])[0, 1])
        e = float(metrics.energy_distance(tensor(df.to_numpy()[::5], dev),
                                          tensor(obs_tp.to_numpy()[::5], dev)))
        res[f"mbcn_{name.replace(' ', '_')}_corr"] = c
        res[f"mbcn_{name.replace(' ', '_')}_energy"] = e
        print(f"  MBCn panel {name:12s} tmax-pr corr {c:+.3f}  energy dist {e:.3f}")
    return res


if __name__ == "__main__":
    main()
