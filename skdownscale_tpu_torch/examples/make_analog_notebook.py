"""Build ``analog_methods.ipynb``, the reference's analog-methods tutorial
on the port, and run it when asked.

The four ``PureAnalog`` selection strategies side by side, then
``AnalogRegression``, a metrics table, scatter panels and a sweep of
``n_analogs``, written with nbformat; ``--execute`` runs it with nbclient
(a Jupyter kernel, from the repository root, on ``--device``) and keeps
the outputs and figures.  The committed notebook has no outputs.

    python -m skdownscale_tpu_torch.examples.make_analog_notebook [--device cpu] [--execute]
"""

from __future__ import annotations

from .make_tutorial_notebook import notebook_parser, run, write
from .make_tutorial_notebook import notebook as _notebook

NAME = "analog_methods.ipynb"

CELLS = [
    (
        "md",
        """# Analog Methods

The GARD family downscales by **analogy**: for each prediction day, find
the historical days whose large-scale predictors look most similar, and
build the prediction from their observed outcomes.  This notebook mirrors
the reference tutorial (`docs/tutorials/analog-methods.ipynb`) on the
PyTorch port:

- `PureAnalog` — four selection strategies over the k nearest analogs;
- `AnalogRegression` — a local linear regression fit on the analogs.

Under the hood both run as **one hand-written CUDA kernel per grid batch**
(K7 and K8 of `skdownscale_tpu_torch/csrc/knn.cu`: the distances in
float32, an exact rank-k selection, then the statistics in registers),
but the single-cell scikit-learn API used here is the reference's.  Run
the notebook from the repository root; `DEVICE` below is the card, set it
to `"cpu"` to run on the CPU in float64.""",
    ),
    (
        "code",
        """%matplotlib inline
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import torch

from skdownscale_tpu_torch import AnalogRegression, PureAnalog
from skdownscale_tpu_torch.examples.utils import get_sample_data
from skdownscale_tpu_torch.models.base import SingleCellEstimator

DEVICE = torch.device("{device}")
SingleCellEstimator.single_cell_device = DEVICE  # the single-cell API's device""",
    ),
    (
        "md",
        """## 1. Data

Daily maximum temperature at one location: a biased GCM-like series
(`training`, the predictor) and observations (`targets`).  Synthetic
stand-ins for the reference's zarr samples —
same shapes and statistics.  First 1000 days train the analog library;
the rest are held out for testing, exactly as in the reference tutorial.""",
    ),
    (
        "code",
        """X = get_sample_data("training")[["tmax"]]
y = get_sample_data("targets")[["tmax"]]

train_size = 1000
X_train, X_test = X[:train_size], X[train_size:]
y_train, y_test = y[:train_size], y[train_size:]
print(f"training: {X_train.index[0].date()} .. {X_train.index[-1].date()}"
      f"  ({len(X_train)} days)")
print(f"testing:  {X_test.index[0].date()} .. {X_test.index[-1].date()}"
      f"  ({len(X_test)} days)")""",
    ),
    (
        "md",
        """## 2. The four `PureAnalog` strategies

| kind | prediction |
|---|---|
| `best_analog` | the single closest analog's observation |
| `sample_analogs` | a random draw from the n best analogs |
| `weight_analogs` | inverse-distance weighted mean of the n best |
| `mean_analogs` | plain mean of the n best |

Each model also returns `exceedance_prob` and `prediction_error`
columns (the GARD output triple).""",
    ),
    (
        "code",
        """strategies = ["best_analog", "sample_analogs", "weight_analogs", "mean_analogs"]
n_analogs = 10
results = {}
for kind in strategies:
    model = PureAnalog(kind=kind, n_analogs=n_analogs, random_state=0)
    model.fit(X_train, y_train)
    pred = model.predict(X_test)
    results[kind] = pd.Series(pred["pred"].to_numpy(), index=X_test.index)
    rmse = float(np.sqrt(np.mean((results[kind].to_numpy() - y_test.to_numpy().ravel()) ** 2)))
    print(f"{kind:>15s}: RMSE {rmse:.3f} K")""",
    ),
    (
        "md",
        """## 3. Visual comparison

First 300 test days, all four strategies against the observations.
Single-day selection (`best_analog`, `sample_analogs`) tracks individual
historical days and is noisier; the averaging strategies
(`weight_analogs`, `mean_analogs`) are smoother but damp extremes.""",
    ),
    (
        "code",
        """plot_days = 300
fig, ax = plt.subplots(figsize=(14, 6))
for kind, pred in results.items():
    ax.plot(pred.index[:plot_days], pred.to_numpy()[:plot_days],
            label=kind.replace("_", " ").title(), alpha=0.7, linewidth=1.2)
ax.plot(y_test.index[:plot_days], y_test.to_numpy()[:plot_days],
        label="Observed", color="black", linewidth=2, alpha=0.5)
ax.set_xlabel("date"); ax.set_ylabel("tmax (K)")
ax.set_title("PureAnalog strategies, first 300 test days")
ax.legend(loc="upper right")
plt.tight_layout()""",
    ),
    (
        "md",
        """## 4. `AnalogRegression`

Instead of averaging the analogs' observations, fit a **local linear
regression** on the n closest analogs and evaluate it at the query —
systematic predictor–predictand relationships survive, while the analog
selection keeps the fit local.  More analogs are used (100 here, as in
the reference tutorial) since they feed a regression, not an average.""",
    ),
    (
        "code",
        """analog_reg = AnalogRegression(n_analogs=100)
analog_reg.fit(X_train, y_train)
pred_reg = pd.Series(analog_reg.predict(X_test)["pred"].to_numpy(), index=X_test.index)
rmse_reg = float(np.sqrt(np.mean((pred_reg.to_numpy() - y_test.to_numpy().ravel()) ** 2)))
print(f"AnalogRegression RMSE: {rmse_reg:.3f} K")""",
    ),
    (
        "code",
        """fig, ax = plt.subplots(figsize=(14, 6))
for kind, pred in results.items():
    ax.plot(pred.index[:plot_days], pred.to_numpy()[:plot_days],
            label=f"PureAnalog: {kind.replace('_', ' ').title()}",
            alpha=0.5, linewidth=1.0)
ax.plot(pred_reg.index[:plot_days], pred_reg.to_numpy()[:plot_days],
        label="AnalogRegression", linewidth=2, alpha=0.85, linestyle="--")
ax.plot(y_test.index[:plot_days], y_test.to_numpy()[:plot_days],
        label="Observed", color="black", linewidth=2, alpha=0.5)
ax.set_xlabel("date"); ax.set_ylabel("tmax (K)")
ax.set_title("All analog methods, first 300 test days")
ax.legend(loc="upper right", fontsize=8)
plt.tight_layout()""",
    ),
    (
        "md",
        """## 5. Quantitative comparison

RMSE, MAE, and correlation for every method on the full test period.""",
    ),
    (
        "code",
        """def calc_metrics(pred, obs):
    p, o = np.asarray(pred).ravel(), np.asarray(obs).ravel()
    return {
        "RMSE": float(np.sqrt(np.mean((p - o) ** 2))),
        "MAE": float(np.mean(np.abs(p - o))),
        "Correlation": float(np.corrcoef(p, o)[0, 1]),
    }

rows = []
for kind, pred in results.items():
    rows.append({"Method": f"PureAnalog ({kind})", **calc_metrics(pred, y_test)})
rows.append({"Method": "AnalogRegression", **calc_metrics(pred_reg, y_test)})
metrics_df = pd.DataFrame(rows).set_index("Method").round(3)
metrics_df""",
    ),
    (
        "md",
        """## 6. Scatter panels

Prediction vs observation per method, with the 1:1 line and R².""",
    ),
    (
        "code",
        """all_methods = {**{f"PureAnalog: {k}": v for k, v in results.items()},
               "AnalogRegression": pred_reg}
fig, axes = plt.subplots(2, 3, figsize=(15, 10))
obs = y_test.to_numpy().ravel()
for ax, (name, pred) in zip(axes.flat, all_methods.items()):
    p = pred.to_numpy().ravel()
    ax.scatter(obs, p, alpha=0.3, s=10)
    lo, hi = min(obs.min(), p.min()), max(obs.max(), p.max())
    ax.plot([lo, hi], [lo, hi], "r--", linewidth=2, label="1:1")
    r2 = float(np.corrcoef(obs, p)[0, 1]) ** 2
    ax.set_title(f"{name}  (R$^2$={r2:.3f})", fontsize=10)
    ax.set_xlabel("observed (K)"); ax.set_ylabel("predicted (K)")
    ax.legend(loc="upper left", fontsize=8)
axes.flat[-1].axis("off")
plt.tight_layout()""",
    ),
    (
        "md",
        """## 7. Sensitivity to `n_analogs`

The reference tutorial's closing question — how many analogs? — answered
with a sweep: single-analog variance vs large-n smoothing for the
averaging strategies and `AnalogRegression`.""",
    ),
    (
        "code",
        """sweep = [1, 5, 10, 25, 50, 100, 200]
fig, ax = plt.subplots(figsize=(9, 5))
for label, make in [
    ("PureAnalog mean_analogs", lambda n: PureAnalog(kind="mean_analogs", n_analogs=n)),
    ("PureAnalog weight_analogs", lambda n: PureAnalog(kind="weight_analogs", n_analogs=n)),
    ("AnalogRegression", lambda n: AnalogRegression(n_analogs=max(n, 3))),
]:
    rmses = []
    for n in sweep:
        m = make(n).fit(X_train, y_train)
        p = m.predict(X_test)["pred"].to_numpy()
        rmses.append(float(np.sqrt(np.mean((p - obs) ** 2))))
    ax.plot(sweep, rmses, marker="o", label=label)
ax.set_xscale("log"); ax.set_xlabel("n_analogs"); ax.set_ylabel("test RMSE (K)")
ax.set_title("Skill vs number of analogs")
ax.legend()
plt.tight_layout()""",
    ),
    (
        "md",
        """## Summary

- `best_analog` / `sample_analogs` preserve day-to-day variability and
  extremes but carry single-day noise;
- `weight_analogs` / `mean_analogs` trade variability for stability, and
  improve with more analogs up to a point;
- `AnalogRegression` usually wins on RMSE/correlation by modeling the
  local predictor–predictand slope rather than averaging outcomes.

At grid scale, wrap any of these in `PointWiseDownscaler`: every valid
cell's k-NN selection and local fits run as one kernel launch on the card
(see `gard_example.py`, and `PERF.md` for the kernels' times).""",
    ),
]


def notebook(device: str = "cuda") -> dict:
    """The notebook (nbformat 4.5, as a dict) with ``DEVICE =
    torch.device(device)``, without outputs."""
    return _notebook(device, CELLS)


def main(argv=None) -> dict:
    args = notebook_parser(__doc__, NAME).parse_args(argv)
    if args.execute:
        from ..utils.device import resolve

        resolve(args.device, "make_analog_notebook --execute")
    nb = notebook(args.device)
    if args.execute:
        nb = run(nb, timeout=600)
    return write(nb, args.path)


if __name__ == "__main__":
    main()
