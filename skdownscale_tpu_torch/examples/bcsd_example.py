"""BCSD example: ``BcsdTemperature`` and ``BcsdPrecipitation`` on the
single-cell API.

Fits ``BcsdTemperature`` on monthly means of daily training data,
bias-corrects the same period and reports the bias and r² against the
observations; then ``BcsdPrecipitation`` (ratio anomalies) on gamma
distributed monthly precipitation.  Synthetic data (``examples.utils``).

    python -m skdownscale_tpu_torch.examples.bcsd_example [--device cpu] [--years 30]
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..utils.device import resolve
from .utils import get_sample_data, on_device, parser, tensor


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--years", type=int, default=30, help="years of sample data, from 1980 (default 30)")
    args = p.parse_args(argv)
    dev = resolve(args.device, "bcsd_example")

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.utils import metrics

    end = str(1980 + args.years - 1)
    training = get_sample_data("training")[:end].resample("MS").mean()
    targets = get_sample_data("targets")[:end].resample("MS").mean()

    bcsd_t = on_device(sdt.BcsdTemperature(return_anoms=False), dev)
    bcsd_t.fit(training, targets)
    out_t = bcsd_t.predict(training)
    res = {
        "raw_bias": float(training["tmax"].mean() - targets["tmax"].mean()),
        "corrected_bias": float(out_t["tmax"].mean() - targets["tmax"].mean()),
        "r2": float(metrics.r2(tensor(targets["tmax"], dev), tensor(out_t["tmax"], dev))),
    }
    print("BcsdTemperature:")
    print(f"  raw bias      : {res['raw_bias']:+.2f} K")
    print(f"  corrected bias: {res['corrected_bias']:+.2f} K")
    print(f"  r2 vs obs     : {res['r2']:.3f}")

    rng = np.random.default_rng(1)
    idx = training.index
    pr_model = pd.DataFrame({"pr": rng.gamma(2.0, 30.0, len(idx)) + 1}, index=idx)
    pr_obs = pd.DataFrame({"pr": rng.gamma(2.2, 25.0, len(idx)) + 1}, index=idx)

    bcsd_p = on_device(sdt.BcsdPrecipitation(return_anoms=False), dev)
    bcsd_p.fit(pr_model, pr_obs)
    out_p = bcsd_p.predict(pr_model)
    res.update(pr_raw_mean=float(pr_model["pr"].mean()), pr_corrected_mean=float(out_p["pr"].mean()),
               pr_obs_mean=float(pr_obs["pr"].mean()))
    print("BcsdPrecipitation:")
    print(f"  raw mean {res['pr_raw_mean']:.1f} -> corrected {res['pr_corrected_mean']:.1f} "
          f"(obs {res['pr_obs_mean']:.1f})")
    return res


if __name__ == "__main__":
    main()
