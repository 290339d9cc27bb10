"""Example data, plotting helpers and the options every example shares.

The data helpers are copies of the JAX package's ``examples/utils.py``
(its ``get_sample_data`` and ``get_sample_grid`` make the same values from
the same seed; ``get_sample_grid`` returns the port's ``xlite``
DataArrays): the reference's examples pull zarr stores from an object store,
so these synthesize statistically similar series (daily and monthly
temperature and wind with a seasonal cycle, bias, trend and spatial
structure).  The plotting helpers mirror the reference's (``prob_plots``
and the z-score diagnostics) and import matplotlib and scipy only when
called.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output")


def get_sample_data(kind: str = "training", seed: int = 0):
    """Synthetic stand-in for the reference's sample data.

    Parameters
    ----------
    kind : {'training', 'targets', 'wind-hist', 'wind-obs', 'wind-rcp'}
        'training' — biased daily GCM-like temperature (K);
        'targets' — observed daily temperature;
        wind flavors mirror the uas example series.

    Returns
    -------
    pd.DataFrame with a daily DatetimeIndex.
    """
    rng = np.random.default_rng(seed)
    if kind in ("training", "targets"):
        index = pd.date_range("1980-01-01", "2009-12-31", freq="D")
        doy = index.dayofyear.to_numpy()
        seasonal = 12 * np.sin(2 * np.pi * (doy - 30) / 365.25)
        base = 285.0 + seasonal + rng.normal(0, 3.5, len(index))
        if kind == "training":
            base = base + 1.8 + 0.00005 * np.arange(len(index))  # bias + drift
            return pd.DataFrame({"tmax": base}, index=index)
        return pd.DataFrame({"tmax": base}, index=index)
    if kind in ("wind-hist", "wind-obs", "wind-rcp"):
        start, end = ("2070-01-01", "2099-12-31") if kind == "wind-rcp" else ("1980-01-01", "2009-12-31")
        index = pd.date_range(start, end, freq="D")
        doy = index.dayofyear.to_numpy()
        seasonal = 1.5 * np.sin(2 * np.pi * doy / 365.25)
        scale = {"wind-hist": 2.0, "wind-obs": 1.7, "wind-rcp": 2.1}[kind]
        uas = seasonal + rng.gamma(2.0, scale, len(index)) - 3.0
        return pd.DataFrame({"uas": uas}, index=index)
    raise ValueError(f"unknown sample data kind: {kind}")


def get_sample_grid(ny: int = 10, nx: int = 10, years: int = 10, seed: int = 0):
    """A small (time, y, x) monthly grid pair (biased GCM, observations)
    with an ocean strip, as the port's xlite DataArrays: the shape of the
    reference's talk demo workload (its 2020ECAHM notebook)."""
    from ..xlite import DataArray

    rng = np.random.default_rng(seed)
    index = pd.date_range("1990-01-01", periods=years * 12, freq="MS")
    seas = 10 * np.sin(2 * np.pi * (index.month.to_numpy() - 1) / 12)[:, None, None]
    lat_grad = np.linspace(-3, 3, ny)[None, :, None]
    gcm = 284 + seas + lat_grad + rng.normal(0, 2, (len(index), ny, nx)) + 1.5
    obs = 283 + seas + lat_grad + rng.normal(0, 1.8, (len(index), ny, nx))
    gcm[:, :, :2] = np.nan  # ocean strip
    coords = {"time": index, "y": np.arange(ny), "x": np.arange(nx)}
    return (
        DataArray(gcm, ("time", "y", "x"), coords),
        DataArray(obs, ("time", "y", "x"), coords),
    )


def prob_plots(x, y, y_hat, shape=(2, 2), figsize=(8, 8)):
    """Q-Q probability plots of each predicted series against the
    observations (the reference's ``prob_plots``)."""
    import matplotlib.pyplot as plt
    import scipy.stats as stats

    fig, axes = plt.subplots(*shape, sharex=True, sharey=True, figsize=figsize)

    (osm, osr), _ = stats.probplot(np.asarray(x).ravel(), fit=True)
    (osm_y, osr_y), _ = stats.probplot(np.asarray(y).ravel(), fit=True)
    for ax, (name, yh) in zip(np.asarray(axes).flat, y_hat.items()):
        (osm_h, osr_h), _ = stats.probplot(np.asarray(yh).ravel(), fit=True)
        ax.plot(osm, osr, "-", label="x")
        ax.plot(osm_y, osr_y, "-", label="y")
        ax.plot(osm_h, osr_h, "--", label=name)
        ax.legend()
        ax.set_title(name)
    return fig


def zscore_ds_plot(training, target, future, corrected, var="uas"):
    """Time-series overlay of the four z-score example series (the
    reference's ``zscore_ds_plot``, on pandas objects, each on its own
    index, with a matplotlib palette)."""
    import matplotlib.pyplot as plt

    labels = ["training", "future", "target", "corrected"]
    cmap = plt.get_cmap("Set2")
    colors = {k: cmap(i) for i, k in enumerate(labels)}
    alpha = 0.5

    def _series(obj):
        if hasattr(obj, "columns") and var in getattr(obj, "columns", ()):
            return obj[var]
        return obj.squeeze()

    plt.figure(figsize=(8, 4))
    for name, obj in (
        ("training", training),
        ("target", target),
        ("future", future),
        ("corrected", corrected),
    ):
        s = _series(obj)
        plt.plot(s.index, np.asarray(s), label=name, alpha=alpha, c=colors[name])
    plt.xlabel("Time")
    plt.ylabel("Eastward Near-Surface Wind (m s-1)")
    plt.legend()
    return plt.gcf()


def _gaus(mean, std, doy):
    import scipy.stats

    mu = mean[doy]
    sigma = std[doy]
    x = np.linspace(mu - 3 * sigma, mu + 3 * sigma, 100)
    y = scipy.stats.norm.pdf(x, mu, sigma)
    return x, y


def zscore_correction_plot(zscore, doy: int = 20):
    """Per-day-of-year Gaussians of a fitted and predicted
    ``ZScoreRegressor`` (the reference's ``zscore_correction_plot``):
    training and target fit statistics, future and corrected rolling
    statistics, all at day of year ``doy``."""
    import matplotlib.pyplot as plt

    training_mean = zscore.fit_stats_dict_["X_mean"]
    training_std = zscore.fit_stats_dict_["X_std"]
    target_mean = zscore.fit_stats_dict_["y_mean"]
    target_std = zscore.fit_stats_dict_["y_std"]

    def _doy_mean(s):
        return s.groupby(s.index.dayofyear).mean()

    future_mean = _doy_mean(zscore.predict_stats_dict_["meani"])
    future_std = _doy_mean(zscore.predict_stats_dict_["stdi"])
    corrected_mean = _doy_mean(zscore.predict_stats_dict_["meanf"])
    corrected_std = _doy_mean(zscore.predict_stats_dict_["stdf"])

    labels = ["training", "future", "target", "corrected"]
    cmap = plt.get_cmap("Set2")
    colors = {k: cmap(i) for i, k in enumerate(labels)}

    plt.figure()
    for name, (m, s) in (
        ("training", (training_mean, training_std)),
        ("target", (target_mean, target_std)),
        ("future", (future_mean, future_std)),
        ("corrected", (corrected_mean, corrected_std)),
    ):
        x, y = _gaus(m, s, doy)
        plt.plot(x, y, c=colors[name], label=name)
    plt.legend()
    return plt.gcf()


# ----------------------------------------------------------------------
# what every example script shares
# ----------------------------------------------------------------------


def parser(doc: str) -> argparse.ArgumentParser:
    """The options of every example: ``--device`` (the card by default;
    ``cpu`` runs the CPU in float64) and ``--out`` (where figures go)."""
    p = argparse.ArgumentParser(description=" ".join((doc or "").strip().split("\n\n")[0].split()),
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device of every estimator and runner (default: cuda)")
    p.add_argument("--out", default=OUT_DIR, help="directory for the figures")
    return p


def on_device(est, device):
    """``est`` with its single-cell API on ``device`` (set on the instance,
    so the class's default stays as it is)."""
    est.single_cell_device = device
    return est


def tensor(a, device):
    """A copy of ``a`` (a pandas column is read-only) on ``device``:
    float32 on the card, float64 on the CPU."""
    from ..utils.device import as_tensor

    return as_tensor(np.array(a, dtype=np.float64), device, "examples")


def pyplot(out_dir: str):
    """matplotlib's pyplot on the Agg backend with ``out_dir`` made, or
    None (and one line saying so) where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("(matplotlib unavailable; skipping the figures)")
        return None
    os.makedirs(out_dir, exist_ok=True)
    return plt


def save(fig, out_dir: str, name: str) -> str:
    """Write ``fig`` to ``out_dir/name`` and close it."""
    import matplotlib.pyplot as plt

    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
