"""The one generator of the benchmark's inputs: daily gridded fields made on
the device from ``--seed``, as a traffic mix's data file describes them.

A mix (``traffic/<mix>.json``) gives the cells of one job, the number of
input sets that jobs take in turn, and its fields, each:

``start``, ``end``
    the first and last day (inclusive, ISO dates): the record's length;
``variables``
    variables a cell (default 1: a field of ``(cells, days)``, else
    ``(cells, days, variables)``);
``loc``, ``cell_loc_sd``
    the mean, and the spread of a cell's own offset from it;
``seasonal_amp``
    the amplitude of ``sin(2 pi (day of year - 1) / 365.25)``;
``trend``
    the rise over the record, linear in time;
``noise_sd``, ``corr``
    the daily noise's standard deviation, and the correlation of the
    variables' noise (equal between every pair).

Every value is float32.  Each (input set, field) has a generator of its
own, seeded from ``--seed``; every seed gives the same sizes.  A field is
made in three large calls on the device: the noise, the cell offsets and
the shared daily base.
"""

from __future__ import annotations

import numpy as np
import torch


def days(start: str, end: str) -> np.ndarray:
    """The days from ``start`` to ``end``, inclusive, as datetime64[D]."""
    return np.arange(np.datetime64(start, "D"), np.datetime64(end, "D") + 1, dtype="datetime64[D]")


def day_of_year(d: np.ndarray) -> np.ndarray:
    return (d - d.astype("datetime64[Y]").astype("datetime64[D]")).astype(np.int64) + 1


def seeds(seed: int, n: int, stream: int = 0) -> list[int]:
    """``n`` 63-bit generator seeds drawn from ``seed`` (any whole number);
    another ``stream`` gives other seeds from the same ``seed``."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64) >> np.uint64(1)]


def field(spec: dict, cells: int, seed: int, device) -> torch.Tensor:
    d = days(spec["start"], spec["end"])
    T, nv = len(d), int(spec.get("variables", 1))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((cells, T, nv), generator=g, device=device, dtype=torch.float32)
    corr = float(spec.get("corr", 0.0))
    if nv > 1 and corr:
        c = np.full((nv, nv), corr) + (1.0 - corr) * np.eye(nv)
        chol_t = torch.as_tensor(np.linalg.cholesky(c).T, dtype=torch.float32, device=device)
        x = x @ chol_t
    x *= float(spec.get("noise_sd", 1.0))
    sd = float(spec.get("cell_loc_sd", 0.0))
    if sd:
        x += sd * torch.randn((cells, 1, 1), generator=g, device=device, dtype=torch.float32)
    t = np.arange(T, dtype=np.float64)
    base = (float(spec.get("loc", 0.0))
            + float(spec.get("seasonal_amp", 0.0)) * np.sin(2 * np.pi * (day_of_year(d) - 1) / 365.25)
            + float(spec.get("trend", 0.0)) * t / max(T - 1, 1))
    x += torch.as_tensor(base, dtype=torch.float32, device=device)[None, :, None]
    return x[..., 0] if "variables" not in spec else x


def inputs(traffic: dict, seed: int, device) -> list[dict]:
    """The mix's input sets: a list of ``{field name: tensor}``."""
    names = sorted(traffic["fields"])
    n_sets = int(traffic.get("input_sets", 1))
    ss = seeds(seed, n_sets * len(names))
    return [{name: field(traffic["fields"][name], int(traffic["cells"]), ss[k * len(names) + i], device)
             for i, name in enumerate(names)} for k in range(n_sets)]


def system_seed(seed: int) -> int:
    """A 32-bit seed for what a system draws itself (MBCn's rotation
    stack), from a stream apart from the fields'."""
    return seeds(seed, 1, stream=1)[0] % (2**32)
