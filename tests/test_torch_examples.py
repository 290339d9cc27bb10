"""The port's examples (``skdownscale_tpu_torch/examples``) on the CPU at a
tiny size: the data helpers bitwise equal to the JAX package's
``examples/utils.py``; each example's ``main`` with ``--device cpu``
returns finite numbers under the keys that ``chip_smoke.py`` reads from
the card run; without a card and without ``--device`` each raises; the
two notebook makers emit valid notebooks whose code cells compile."""

import importlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

from skdownscale_tpu_torch.examples import utils as pu

ROOT = Path(__file__).parents[1]

# each example: the arguments of a tiny CPU run, keys its result holds, and
# what its prose asserts of them
TINY = {
    "bcsd_example": (["--years", "3"], {"raw_bias", "corrected_bias", "r2", "pr_corrected_mean"},
                     lambda r: abs(r["corrected_bias"]) < 0.05 < abs(r["raw_bias"])),
    "gard_example": (["--years", "2"], {"PureAnalog-best-1", "PureAnalog-sample-10",
                                        "PureAnalog-weight-10", "PureAnalog-mean-10",
                                        "AnalogRegression-100", "PureRegression"},
                     lambda r: all(0.9 < m["r"] <= 1.0 for m in r.values())),
    "mbcn_example": (["--years", "2", "--iterations", "3"],
                     {"corr_obs", "corr_corrected", "energy_raw", "energy_corrected"},
                     lambda r: r["energy_corrected"] < r["energy_raw"] and r["pr_positive"] == 1.0),
    "global_models_example": (["--days", "365", "--ny", "6", "--nx", "8"],
                              {"bias_before", "bias_after", "rmse", "slope"},
                              lambda r: abs(r["bias_after"]) < 0.01 and abs(r["slope"] - 1 / 1.15) < 1e-3),
    "sharded_grid": (["--side", "4", "--years", "3"], {"corrected_mean", "time_sharded_bitwise"},
                     lambda r: r["time_sharded_bitwise"] == 1.0),
    "full_bcsd_pipeline": (["--ny", "3", "--nx", "4", "--scale", "2", "--years", "2"],
                           {"mean_abs_anomaly", "fine_monthly_mean", "conservation_error"},
                           lambda r: r["conservation_error"] < 1e-9),
    "continental_bcsd": (["--n-side", "8", "--check-cells", "8"],
                         {"streaming", "wall_s", "fit_s", "predict_s", "corrected_mean", "check_max"},
                         lambda r: r["streaming"] == 0.0 and r["ocean_nan"] == 1.0 and r["check_p999"] < 1e-3),
    "tutorial": (["--years", "3", "--side", "4"],
                 {"raw_bias", "BCSD_rmse", "grid_corrected_abs_bias", "zscore_corrected_mean",
                  "disagg_conservation_error", "mbcn_MBCn_future_energy"},
                 lambda r: r["grid_corrected_abs_bias"] < r["grid_raw_abs_bias"]),
}


def _example(name):
    return importlib.import_module(f"skdownscale_tpu_torch.examples.{name}")


def _numbers(res):
    """Every number of a result, nested dicts flattened."""
    for v in res.values():
        if isinstance(v, dict):
            yield from _numbers(v)
        else:
            yield v


@pytest.fixture(scope="module")
def smoke_limits():
    """``chip_smoke.py``'s limit of every number of each example, by the
    example's name (``--zarr`` appended for that form)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {name + (" --zarr" if "--zarr" in args else ""): limits
            for name, args, _, _, limits in mod.EXAMPLES}


def _flat_keys(res, prefix=""):
    for k, v in res.items():
        if isinstance(v, dict):
            yield from _flat_keys(v, f"{prefix}{k}.")
        else:
            yield prefix + k


@pytest.fixture(scope="module")
def jax_utils():
    """The JAX package's ``examples/utils.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_example_utils", ROOT / "examples" / "utils.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["training", "targets", "wind-hist", "wind-obs", "wind-rcp"])
def test_sample_data_is_the_jax_examples(jax_utils, kind):
    a, b = pu.get_sample_data(kind, seed=5), jax_utils.get_sample_data(kind, seed=5)
    pd.testing.assert_frame_equal(a, b, check_exact=True)


def test_sample_grid_is_the_jax_examples(jax_utils):
    for a, b in zip(pu.get_sample_grid(ny=4, nx=5, years=2, seed=3),
                    jax_utils.get_sample_grid(ny=4, nx=5, years=2, seed=3)):
        npt.assert_array_equal(np.asarray(a.values), np.asarray(b.values))
        assert a.dims == b.dims
        assert pd.DatetimeIndex(a.coords["time"]).equals(pd.DatetimeIndex(b.coords["time"]))
        assert type(a).__module__ == "skdownscale_tpu_torch.xlite"


def test_the_cli_takes_the_examples_grid():
    from skdownscale_tpu_torch import cli

    assert cli.get_sample_grid is pu.get_sample_grid


@pytest.mark.parametrize("name", sorted(TINY))
def test_example_runs_on_the_cpu(name, tmp_path, smoke_limits):
    """...and ``chip_smoke.py`` names a limit for each of its numbers."""
    args, keys, holds = TINY[name]
    res = _example(name).main([*args, "--device", "cpu", "--out", str(tmp_path)])
    assert keys <= set(res), f"{name}: missing {keys - set(res)}"
    assert set(_flat_keys(res)) == smoke_limits[name].keys()
    numbers = list(_numbers(res))
    assert numbers and all(isinstance(v, float) and math.isfinite(v) for v in numbers), res
    assert holds(res), res


def test_continental_zarr_form_on_the_cpu(tmp_path, smoke_limits):
    mod = _example("continental_bcsd")
    store = tmp_path / "grid.zarr"
    res = mod.main(["--n-side", "8", "--device", "cpu", "--zarr", str(store)])
    assert res["ocean_nan"] == 1.0 and res["cells"] == 64.0
    assert set(res) == smoke_limits["continental_bcsd --zarr"].keys()
    assert all(math.isfinite(v) for v in res.values())
    assert (tmp_path / "grid.zarr.corrected").exists()


@pytest.mark.parametrize("name", sorted(TINY) + ["make_tutorial_notebook", "make_analog_notebook"])
def test_example_raises_without_a_card(name, monkeypatch):
    """No example falls back to the CPU: ``--device`` defaults to the card,
    and without one the example raises before it computes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = TINY[name][0] if name in TINY else ["--execute", "--path", "unused.ipynb"]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _example(name).main(args)


@pytest.mark.parametrize("name", ["make_tutorial_notebook", "make_analog_notebook"])
def test_notebook_maker(name, tmp_path, smoke_limits):
    """A valid nbformat document (written as JSON without nbformat, which
    the card's machine lacks) whose code cells compile, without outputs,
    its ``DEVICE`` the one asked for; the committed notebook is the
    one it makes."""
    nbf = pytest.importorskip("nbformat")
    mod = _example(name)
    path = tmp_path / "nb.ipynb"
    res = mod.main(["--device", "cpu", "--path", str(path)])
    nb = nbf.read(str(path), as_version=4)
    nbf.validate(nb)
    assert res["cells"] == len(nb.cells) and res["figures"] == 0
    assert set(res) == smoke_limits[name].keys()
    code = [c.source for c in nb.cells if c.cell_type == "code"]
    assert 'DEVICE = torch.device("cpu")' in code[0]
    for src in code:
        compile("\n".join(line for line in src.splitlines() if not line.startswith("%")), "<cell>", "exec")
        assert "jax" not in src and "skdownscale_tpu." not in src
    committed = nbf.read(str(Path(mod.__file__).with_name(mod.NAME)), as_version=4)
    assert [c.source for c in committed.cells] == [c["source"] for c in mod.notebook()["cells"]]
    assert not any(c.get("outputs") for c in committed.cells if c.cell_type == "code")
