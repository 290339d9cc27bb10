"""Build ``tutorial.ipynb``, the notebook form of ``tutorial.py``, and run
it when asked.

Markdown narration and code cells, written with nbformat; ``--execute``
runs it with nbclient (a Jupyter kernel, from the repository root, on
``--device``) and keeps the outputs and figures.  The committed notebook
has no outputs.

    python -m skdownscale_tpu_torch.examples.make_tutorial_notebook [--device cpu] [--execute]
"""

from __future__ import annotations

import argparse
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
NAME = "tutorial.ipynb"

CELLS = [
    (
        "md",
        """# Downscaling with scikit-downscale on PyTorch

An end-to-end walkthrough of the port (`skdownscale_tpu_torch`), mirroring
the reference library's talk notebook and tutorials:

1. load daily GCM-like training data and observations;
2. fit a panel of downscaling models on the single-cell scikit-learn API;
3. compare them with skill metrics and Q-Q probability plots;
4. scale BCSD over a `(time, y, x)` grid with `PointWiseDownscaler`, every
   valid cell at once on the card (the reference loops a Python estimator
   per cell);
5. correct wind speeds with `ZScoreRegressor` and reproduce the
   reference's z-score diagnostic figures;
6. disaggregate the corrected monthly grid to daily with
   `bcsd_disaggregator`, the final BCSD step;
7. correct tmax and pr *jointly* with `MBCn` and check it with the energy
   distance.

The data are synthetic stand-ins with the shapes and statistics of the
reference's zarr samples (`skdownscale_tpu_torch/examples/utils.py`).  Run
the notebook from the repository root.  `DEVICE` below is the card; set it
to `"cpu"` to run on the CPU in float64.""",
    ),
    (
        "code",
        """%matplotlib inline
import numpy as np
import pandas as pd
import torch

import skdownscale_tpu_torch as sdt
from skdownscale_tpu_torch.examples.utils import get_sample_data, get_sample_grid, prob_plots, tensor
from skdownscale_tpu_torch.models.base import SingleCellEstimator
from skdownscale_tpu_torch.utils import metrics

DEVICE = torch.device("{device}")
SingleCellEstimator.single_cell_device = DEVICE  # the single-cell API's device""",
    ),
    (
        "md",
        """## 1. Data

Thirty years of daily maximum temperature: a biased, drifting GCM series
(`training`) and observations (`targets`) at the same location.  We fit on
1980–1999 and evaluate on the held-out 2000–2009 decade.""",
    ),
    (
        "code",
        """training = get_sample_data("training")
targets = get_sample_data("targets")
split = "2000-01-01"
X_hist, X_fut = training[:split], training[split:]
y_hist, y_fut = targets[:split], targets[split:]
print(f"training {X_hist.shape}, evaluation {X_fut.shape}")
print(f"raw GCM bias over the evaluation decade: "
      f"{float(X_fut['tmax'].mean() - y_fut['tmax'].mean()):+.2f} K")
X_hist.tail()""",
    ),
    (
        "md",
        """## 2. A panel of downscaling models

Each estimator keeps the reference's scikit-learn style single-cell API,
`fit(X, y)` / `predict(X)` on pandas with a `DatetimeIndex`, while the
numerics run as batched PyTorch operations and CUDA kernels underneath.""",
    ),
    (
        "code",
        """models = {
    "BCSD: BcsdTemperature": sdt.BcsdTemperature(return_anoms=False),
    "QDM: EquidistantCdfMatcher": sdt.EquidistantCdfMatcher(
        kind="difference", extrapolate="both"
    ),
    "QM: QuantileMappingReressor": sdt.QuantileMappingReressor(extrapolate="both"),
    "ZScore: ZScoreRegressor": sdt.ZScoreRegressor(window_width=31),
}

def scores(obs, yh):
    o, h = tensor(obs, DEVICE), tensor(yh, DEVICE)
    return {
        "bias (K)": float(yh.mean() - obs.mean()),
        "rmse (K)": float(metrics.rmse(o, h)),
        "r2": float(metrics.r2(o, h)),
        # distribution-shape checks: two-sample KS and 95th-percentile bias
        "KS": float(metrics.ks_stat(o, h)),
        "q95 bias (K)": float(metrics.quantile_bias(o, h, 0.95)),
    }

preds, rows = {}, []
obs = y_fut["tmax"].to_numpy()
rows.append({"model": "(raw GCM)", **scores(obs, X_fut["tmax"].to_numpy())})
for name, model in models.items():
    model.fit(X_hist, y_hist["tmax"])
    yh = np.asarray(model.predict(X_fut)).reshape(-1)
    preds[name] = yh
    ok = np.isfinite(yh) & np.isfinite(obs)
    rows.append({"model": name, **scores(obs[ok], yh[ok])})
pd.DataFrame(rows).set_index("model").round(3)""",
    ),
    (
        "md",
        """All four models remove the ~2 K bias; the quantile methods also match
the observed distribution's shape, which the Q-Q plots below make visible.

## 3. Q-Q probability plots

The reference's `prob_plots` diagnostic: observed and modelled quantiles
against Cunnane plotting positions; a perfect correction hugs the
observations' line.""",
    ),
    (
        "code",
        """fig = prob_plots(
    X_fut["tmax"].to_numpy(),
    y_fut["tmax"].to_numpy(),
    {k: np.nan_to_num(v, nan=np.nanmean(v)) for k, v in preds.items()},
    shape=(2, 2),
)""",
    ),
    (
        "md",
        """## 4. The same correction over a grid

`PointWiseDownscaler` maps an estimator over every cell of a
`(time, y, x)` grid.  The reference does this with a Python loop over
per-cell estimator objects; here all valid cells are packed into one batch
on the device, NaN (ocean) cells are masked out, and the fitted state is a
set of `(cells, ...)` tensors, which a cell mesh shards over cards (see
`sharded_grid.py`).""",
    ),
    (
        "code",
        """gcm, obs_grid = get_sample_grid(ny=12, nx=12, years=10)
d = sdt.PointWiseDownscaler(sdt.BcsdTemperature(return_anoms=False), device=DEVICE)
d.fit(gcm, obs_grid)
out = d.predict(gcm)

v = np.asarray(out.values)
raw_bias = np.asarray(gcm.values).mean(axis=0) - np.asarray(obs_grid.values).mean(axis=0)
cor_bias = v.mean(axis=0) - np.asarray(obs_grid.values).mean(axis=0)
print(f"grid: raw |bias| {np.nanmean(np.abs(raw_bias)):.2f} K -> "
      f"corrected {np.nanmean(np.abs(cor_bias)):.2f} K; "
      f"ocean NaN preserved: {bool(np.isnan(v[:, :, :2]).all())}")

import matplotlib.pyplot as plt
fig, axes = plt.subplots(1, 2, figsize=(9, 4), sharey=True)
for ax, (title, field) in zip(
    axes, [("raw GCM bias (K)", raw_bias), ("after BCSD (K)", cor_bias)]
):
    im = ax.imshow(field, cmap="RdBu_r", vmin=-2, vmax=2, origin="lower")
    ax.set_title(title)
fig.colorbar(im, ax=axes, shrink=0.8);""",
    ),
    (
        "md",
        """## 5. Z-score wind correction

The reference's z-score tutorial, with its two diagnostic figures: the
corrected future series, and the fitted day-of-year Gaussian
parameters.""",
    ),
    (
        "code",
        """from skdownscale_tpu_torch.examples.utils import zscore_correction_plot, zscore_ds_plot

hist = get_sample_data("wind-hist")
wobs = get_sample_data("wind-obs")
rcp = get_sample_data("wind-rcp")
z = sdt.ZScoreRegressor()
z.fit(hist, wobs)
zout = z.predict(rcp)
f1 = zscore_ds_plot(hist, wobs, rcp, zout)
f2 = zscore_correction_plot(z)""",
    ),
    (
        "md",
        """## 6. Monthly → daily: the "SD" in BCSD

Each bias-corrected monthly value is spread over its days with the obs
daily climatology's within-month pattern (additive for temperature), and
every output month's mean equals the monthly input (conservation).  The
calendar is host membership matrices; the device work is three
mean-pooling products batched over the whole grid.""",
    ),
    (
        "code",
        """from skdownscale_tpu_torch.utils.disagg import bcsd_disaggregator
from skdownscale_tpu_torch.xlite import DataArray

oi = pd.date_range("1990-01-01", "1994-12-31", freq="D")
doy = np.asarray(oi.dayofyear)
rng = np.random.default_rng(1)
obs_daily = (283 + 10 * np.sin(2 * np.pi * doy / 365.25)[:, None, None]
             + rng.normal(0, 2, (len(oi), 12, 12)))
obs_daily_da = DataArray(obs_daily, ("time", "y", "x"),
                         {"time": oi, "y": np.arange(12), "x": np.arange(12)})

daily = bcsd_disaggregator(out, obs_daily_da, kind="temperature", device=DEVICE)
dvals, dtime = np.asarray(daily.data), daily.coords["time"]
key = np.asarray(dtime.year) * 100 + np.asarray(dtime.month)
mvals = np.asarray(out.values)
cons = max(float(np.nanmax(np.abs(dvals[key == k].mean(axis=0) - mvals[i])))
           for i, k in enumerate(np.unique(key)))
print(f"{dvals.shape[0]} daily steps; max conservation error {cons:.2e} K")

sel = slice(0, 730)  # two years at one land cell
fig, ax = plt.subplots(figsize=(9, 3.2))
ax.plot(np.asarray(dtime)[sel], dvals[sel, 6, 6], lw=0.6,
        label="daily (disaggregated)")
ax.step(np.asarray(out.coords["time"])[:24], mvals[:24, 6, 6], where="post",
        lw=1.8, color="C1", label="monthly (bias-corrected)")
ax.set_ylabel("K"); ax.legend(loc="upper right");""",
    ),
    (
        "md",
        """## 7. Correct several variables jointly (MBCn)

Everything above corrects one variable at a time, which leaves
cross-variable dependence (hot-dry spells, warm-wet storms) at the
model's values.  `MBCn` (Cannon 2018's N-dimensional pdf transform)
corrects the *joint* distribution: QDM margins per variable, then rounds of
random rotations with a quantile map of each rotated coordinate.""",
    ),
    (
        "code",
        """from skdownscale_tpu_torch.examples.mbcn_example import make_series

rng = np.random.default_rng(7)
days = lambda a, b: pd.date_range(f"{a}-01-01", f"{b}-12-31", freq="D")
obs_tp = make_series(rng, days(1980, 1999), -0.6, 0.0, 2.0)
hist_tp = make_series(rng, days(1980, 1999), -0.1, 2.0, 3.0)
fut_tp = make_series(rng, days(2050, 2069), -0.1, 2.8, 3.2)

mb = sdt.MBCn(n_iterations=25, kind=("difference", "ratio"), random_state=0)
corrected_tp = mb.fit(hist_tp, obs_tp).predict(fut_tp)

rows = []
for name, df in [("obs", obs_tp), ("raw future", fut_tp), ("MBCn future", corrected_tp)]:
    rows.append({
        "series": name,
        "tmax-pr corr": float(np.corrcoef(df["tmax"], df["pr"])[0, 1]),
        "energy dist to obs": float(metrics.energy_distance(
            tensor(df.to_numpy()[::5], DEVICE), tensor(obs_tp.to_numpy()[::5], DEVICE))),
    })
pd.DataFrame(rows).set_index("series").round(3)""",
    ),
    (
        "md",
        """The corrected future recovers the observed (negative) tmax–pr
correlation, while the QDM margins keep the model's warming and wetting
deltas; `mbcn_example.py` draws the joint scatter and `models.mbc.mbcn_grid`
runs the same correction over a grid.

## 8. Scaling up

The same API at continental scale on the card:

- `continental_bcsd.py`: a grid of 10^5–10^6 cells through one
  `PointWiseDownscaler` pass (dense, or the streaming formulation from
  2,000,000 cells), or store to store with `--zarr`;
- `sharded_grid.py`: the same program over a cell mesh of several cards,
  and QDM over a (cells, time) mesh;
- `global_models_example.py`: pooled models whose sufficient statistics
  and quantile sketches reduce across the mesh.

Measured times on the card are in `PERF.md`.""",
    ),
]


def notebook(device: str = "cuda", cells=None) -> dict:
    """The notebook (nbformat 4.5, as a dict) of ``cells`` (this module's
    by default) with ``DEVICE = torch.device(device)``, without outputs.
    Written as plain JSON: the card's machine has no nbformat."""
    out = []
    for i, (kind, src) in enumerate(CELLS if cells is None else cells):
        cell = {"cell_type": "markdown" if kind == "md" else "code", "id": f"cell-{i}", "metadata": {},
                "source": src if kind == "md" else src.replace("{device}", device)}
        if kind != "md":
            cell.update(execution_count=None, outputs=[])
        out.append(cell)
    return {"cells": out, "metadata": {"kernelspec": {"name": "python3", "display_name": "Python 3",
                                                      "language": "python"},
                                       "language_info": {"name": "python"}},
            "nbformat": 4, "nbformat_minor": 5}


def run(nb: dict, timeout: int = 900) -> dict:
    """Execute ``nb`` with nbclient in a Jupyter kernel started in the
    repository root; the notebook with its outputs."""
    import nbformat
    from nbclient import NotebookClient

    node = nbformat.from_dict(nb)
    NotebookClient(node, timeout=timeout, kernel_name="python3",
                   resources={"metadata": {"path": REPO}}).execute()
    return node


def write(nb: dict, path: str) -> dict:
    """Write ``nb`` as nbformat does (JSON, one-space indent) and count its
    cells and the figures among its outputs."""
    with open(path, "w") as f:
        json.dump(nb, f, indent=1, ensure_ascii=False)
        f.write("\n")
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    figures = sum(1 for c in code for o in c["outputs"]
                  if o.get("output_type") == "display_data" and "image/png" in o.get("data", {}))
    res = {"cells": float(len(nb["cells"])), "code_cells": float(len(code)), "figures": float(figures)}
    print(f"wrote {path} ({len(nb['cells'])} cells, {figures} figures)")
    return res


def notebook_parser(doc: str, name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=" ".join(doc.strip().split("\n\n")[0].split()))
    p.add_argument("--device", default="cuda", help="DEVICE of the notebook (default: cuda)")
    p.add_argument("--execute", action="store_true", help="run the notebook and keep its outputs")
    p.add_argument("--path", default=os.path.join(HERE, name), help=f"where to write it (default: {name} here)")
    return p


def main(argv=None) -> dict:
    args = notebook_parser(__doc__, NAME).parse_args(argv)
    if args.execute:
        from ..utils.device import resolve

        resolve(args.device, "make_tutorial_notebook --execute")
    nb = notebook(args.device)
    if args.execute:
        nb = run(nb)
    return write(nb, args.path)


if __name__ == "__main__":
    main()
