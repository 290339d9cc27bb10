"""The port's BCSD runner (``python -m skdownscale_tpu_torch.cli``) against
``scripts/run_bcsd.py`` on ``tests/test_cli.py``'s data, on the CPU in
float64: the monthly output and the temporally disaggregated daily output
within ``atol = 1e-10`` (the same float64 arithmetic in another order), the
same JSON lines, the same ``.npz`` layout."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax

from skdownscale_tpu_torch import cli

ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Drop this module's compiled JAX programs before and after it, as
    ``tests/test_torch_mbc.py`` does (one process holds every module's)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def jax_cli():
    spec = importlib.util.spec_from_file_location(
        "run_bcsd_cli", str(Path(__file__).parents[1] / "scripts" / "run_bcsd.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_grid(path, data, index):
    np.savez(path, data=data, time=np.asarray(index).astype("datetime64[ns]"))
    return str(path)


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("kind", ["temperature", "precipitation"])
def test_cli_matches_the_jax_runner_with_daily_disagg(tmp_path, rng, capsys, jax_cli, kind):
    ny, nx = 2, 3
    mi = pd.date_range("1980-01-01", periods=120, freq="MS")
    season = 8 * np.sin(2 * np.pi * (np.asarray(mi.month) - 1) / 12)[:, None, None]
    obs = 283 + season + rng.normal(0, 2, (120, ny, nx))
    ref = obs + 1.5 + rng.normal(0, 0.5, obs.shape)
    oi = pd.date_range("1980-01-01", "1983-12-31", freq="D")
    doy = np.asarray(oi.dayofyear)
    obs_daily = 283 + 8 * np.sin(2 * np.pi * doy / 365.25)[:, None, None] + rng.normal(
        0, 2, (len(oi), ny, nx)
    )
    if kind == "precipitation":
        obs, ref, obs_daily = (np.abs(a - 280) for a in (obs, ref, obs_daily))
    args = [
        "--obs", _write_grid(tmp_path / "obs.npz", obs, mi),
        "--ref", _write_grid(tmp_path / "ref.npz", ref, mi),
        "--predict", _write_grid(tmp_path / "ref2.npz", ref, mi),
        "--kind", kind,
        "--no-anoms",
        "--daily-obs", _write_grid(tmp_path / "obsd.npz", obs_daily, oi),
    ]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    cli.main(args + ["--out", ours, "--device", "cpu"])
    got_lines = _json_lines(capsys.readouterr().out)
    jax_cli.main(args + ["--out", theirs])
    want_lines = _json_lines(capsys.readouterr().out)
    assert [sorted(a) for a in got_lines] == [sorted(b) for b in want_lines]
    assert got_lines[0]["cells"] == ny * nx and got_lines[0]["time_steps"] == 120
    assert got_lines[1]["daily_steps"] == want_lines[1]["daily_steps"]
    for suffix in ("", ".daily.npz"):
        with np.load(ours + suffix) as a, np.load(theirs + suffix) as b:
            assert sorted(a.files) == sorted(b.files) == ["data", "time"]
            assert a["data"].dtype == np.float64
            npt.assert_array_equal(a["time"], b["time"])
            npt.assert_allclose(a["data"], b["data"], rtol=0, atol=ATOL)


def test_cli_demo_and_argument_errors(tmp_path, rng, capsys, monkeypatch):
    cli.main(["--demo", "--out", str(tmp_path / "demo.npz"), "--device", "cpu"])
    assert "cells_per_sec" in capsys.readouterr().out
    with np.load(str(tmp_path / "demo.npz")) as z:
        data = z["data"]
    assert data.shape == (240, 20, 20) and np.isnan(data[:, :, :2]).all()
    assert np.isfinite(data[:, :, 2:]).all()
    mi = pd.date_range("1980-01-01", periods=24, freq="MS")
    a = _write_grid(tmp_path / "g.npz", 283 + rng.normal(0, 2, (24, 2, 2)), mi)
    with pytest.raises(SystemExit):
        cli.main(["--obs", a, "--ref", a, "--predict", a, "--daily-obs", a,
                  "--out", str(tmp_path / "o.npz"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--obs", a, "--out", str(tmp_path / "o.npz"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--obs", a, "--ref", a, "--predict", a, "--out", str(tmp_path / "o.npz")])


def test_demo_grid_equals_the_examples_generator():
    import sys

    sys.path.insert(0, str(Path(__file__).parents[1] / "examples"))
    try:
        from utils import get_sample_grid
    finally:
        sys.path.pop(0)
    for (a, b) in zip(cli.get_sample_grid(ny=4, nx=5, years=2, seed=3),
                      get_sample_grid(ny=4, nx=5, years=2, seed=3)):
        npt.assert_array_equal(a.values, b.values)
        assert a.dims == b.dims
        assert pd.DatetimeIndex(a.coords["time"]).equals(pd.DatetimeIndex(b.coords["time"]))
