"""Multivariate bias correction example (MBCn, Cannon 2018).

Correcting tmax and pr one at a time leaves their cross-correlation at the
model's: compound events (hot-dry spells, warm-wet storms) keep the model's
dependence, not the observed one.  ``MBCn`` corrects the joint
distribution: QDM margins, then random rotations with a quantile map of
each rotated coordinate.

Prints the tmax-pr correlation and the multivariate energy distance to the
observations before and after, and, with matplotlib, saves a joint scatter
to ``--out``/mbcn_joint.png.

    python -m skdownscale_tpu_torch.examples.mbcn_example [--device cpu] [--years 20]
"""

from __future__ import annotations

import numpy as np

from ..utils.device import resolve
from .utils import on_device, parser, pyplot, save, tensor


def make_series(rng, index, corr_tp, t_bias=0.0, p_scale=1.0):
    """tmax (K) and pr (mm/day) with a seasonal cycle and the given
    dependence."""
    import pandas as pd

    n = len(index)
    doy = np.asarray(index.dayofyear)
    L = np.linalg.cholesky(np.array([[1.0, corr_tp], [corr_tp, 1.0]]))
    z = rng.standard_normal((n, 2)) @ L.T
    tmax = 285 + 10 * np.sin(2 * np.pi * doy / 365.25) + 3 * z[:, 0] + t_bias
    pr = np.maximum(0.05, np.exp(0.8 * z[:, 1]) * p_scale)
    return pd.DataFrame({"tmax": tmax, "pr": pr}, index=index)


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--years", type=int, default=20, help="years of each period (default 20)")
    p.add_argument("--iterations", type=int, default=25, help="MBCn rotations (default 25)")
    args = p.parse_args(argv)
    dev = resolve(args.device, "mbcn_example")

    import pandas as pd

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.utils import metrics

    def period(start):
        return pd.date_range(f"{start}-01-01", f"{start + args.years - 1}-12-31", freq="D")

    rng = np.random.default_rng(7)
    obs = make_series(rng, period(1980), -0.6, 0.0, 2.0)
    hist = make_series(rng, period(1980), -0.1, 2.0, 3.0)
    fut = make_series(rng, period(2050), -0.1, 2.8, 3.2)

    model = on_device(sdt.MBCn(n_iterations=args.iterations, kind=("difference", "ratio"),
                               random_state=0), dev)
    model.fit(hist, obs)
    corrected = model.predict(fut)

    def report(name, df):
        c = float(np.corrcoef(df["tmax"], df["pr"])[0, 1])
        e = float(metrics.energy_distance(tensor(df.to_numpy()[::5], dev),
                                          tensor(obs.to_numpy()[::5], dev)))
        print(f"  {name:14s} tmax-pr corr {c:+.3f}   energy distance to obs {e:.3f}")
        return c, e

    print("joint-distribution diagnostics (obs dependence is the target):")
    c_obs, _ = report("obs", obs)
    c_raw, e_raw = report("raw future", fut)
    c_cor, e_cor = report("MBCn future", corrected)
    res = {"corr_obs": c_obs, "corr_raw": c_raw, "corr_corrected": c_cor, "energy_raw": e_raw,
           "energy_corrected": e_cor, "energy_reduction": e_raw / max(e_cor, 1e-9),
           "pr_positive": float((corrected["pr"] > 0).all())}
    print(f"  energy distance reduced {res['energy_reduction']:.1f}x; "
          f"pr > 0 everywhere: {bool(res['pr_positive'])}")

    plt = pyplot(args.out)
    if plt is None:
        return res
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.6), sharex=True, sharey=True)
    for ax, (title, df) in zip(
        axes, [("observations", obs), ("raw future", fut), ("MBCn-corrected future", corrected)]
    ):
        ax.scatter(df["tmax"][::10], df["pr"][::10], s=3, alpha=0.3)
        ax.set_title(title)
        ax.set_xlabel("tmax (K)")
        ax.set_yscale("log")
    axes[0].set_ylabel("pr (mm/day, log)")
    print(f"saved joint-distribution scatter -> {save(fig, args.out, 'mbcn_joint.png')}")
    return res


if __name__ == "__main__":
    main()
