"""GARD example: ``PureAnalog`` (every kind), ``AnalogRegression`` and
``PureRegression`` on daily wind, compared by skill.

Each model is fit on the historical period and scored against the
observations (rmse and Pearson r); each also predicts the future period,
reported by its mean.  Synthetic data (``examples.utils``).

    python -m skdownscale_tpu_torch.examples.gard_example [--device cpu] [--years 30]
"""

from __future__ import annotations

import numpy as np

from ..utils.device import resolve
from .utils import get_sample_data, on_device, parser, tensor


def models():
    """The six GARD models of the example, by name."""
    import skdownscale_tpu_torch as sdt

    return {
        "PureAnalog-best-1": sdt.PureAnalog(kind="best_analog", n_analogs=1),
        "PureAnalog-sample-10": sdt.PureAnalog(kind="sample_analogs", n_analogs=10, random_state=0),
        "PureAnalog-weight-10": sdt.PureAnalog(kind="weight_analogs", n_analogs=10),
        "PureAnalog-mean-10": sdt.PureAnalog(kind="mean_analogs", n_analogs=10),
        "AnalogRegression-100": sdt.AnalogRegression(n_analogs=100),
        "PureRegression": sdt.PureRegression(),
    }


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--years", type=int, default=30, help="years of each sample series (default 30)")
    args = p.parse_args(argv)
    dev = resolve(args.device, "gard_example")

    from skdownscale_tpu_torch.utils import metrics

    n = args.years * 365
    hist = get_sample_data("wind-hist")[:n]
    obs = get_sample_data("wind-obs")[:n]
    rcp = get_sample_data("wind-rcp")[:n]

    y = tensor(obs["uas"], dev)
    res = {}
    print(f"{'model':<24} {'rmse':>7} {'r':>6} {'future mean':>12}")
    for name, model in models().items():
        on_device(model, dev)
        model.fit(hist, obs["uas"])
        pred = tensor(np.asarray(model.predict(hist))[:, 0], dev)
        future = np.asarray(model.predict(rcp))[:, 0]
        res[name] = {"rmse": float(metrics.rmse(y, pred)), "r": float(metrics.pearsonr(y, pred)),
                     "future_mean": float(np.mean(future, dtype=np.float64))}
        print(f"{name:<24} {res[name]['rmse']:7.3f} {res[name]['r']:6.3f} {res[name]['future_mean']:12.3f}")
    return res


if __name__ == "__main__":
    main()
