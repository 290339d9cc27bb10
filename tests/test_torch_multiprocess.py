"""Multi-process feeding really runs (``tests/test_multiprocess.py`` for the
port).

Two OS processes join a gloo group on localhost through
``python -m skdownscale_tpu_torch.parallel.dryrun``; each feeds its
``host_cell_slice`` of a zarr store through ``feed_zarr_cells`` (the
several-process branch of ``parallel/multihost.feed_cells``), runs the BCSD
fit + predict on its 4 shards of the global 8-shard CPU mesh and fits the
pooled quantile sketch (its ``all_gather`` and ``all_reduce`` cross the
processes).  The reassembled output and the ladder must be bitwise equal to
a one-process run of the same 8-shard mesh (``dryrun.dry_run`` in the test's
process), and agree with the JAX
package's batched BCSD core and its sketch on 8 virtual devices within
1e-9 and 1e-10 (float64, other summation orders).  Each job has a timeout.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import skdownscale_tpu.global_models.quantile as JQ
from skdownscale_tpu.models.bcsd import BcsdTemperature, bcsd_fit, bcsd_predict
from skdownscale_tpu.parallel import mesh as jmesh

from skdownscale_tpu_torch.parallel import cell_mesh
from skdownscale_tpu_torch.parallel.dryrun import dry_run, run_job
from skdownscale_tpu_torch.utils import zarrlite

N_CELLS, N_TIME, M, Q = 30, 48, 64, 33


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _write_store(path):
    rng = np.random.default_rng(0)
    index = pd.date_range("1990-01-01", periods=N_TIME, freq="MS")
    seasonal = 8.0 * np.sin(2 * np.pi * (index.month.to_numpy() - 1) / 12)
    x = 283.0 + seasonal[:, None] + rng.normal(0, 2, (N_TIME, N_CELLS)) + 1.5
    y = 282.0 + seasonal[:, None] + rng.normal(0, 1.8, (N_TIME, N_CELLS))
    x[:, 4] = y[:, 4] = np.nan  # an ocean cell
    tvals = np.asarray(index, dtype="datetime64[ns]").view(np.int64)
    zarrlite.save_group(path, {"gcm": x, "obs": y}, chunks=(N_TIME, 7))
    zarrlite.save_array(path, tvals, prefix="time", attrs={"kind": "datetime64[ns]"})
    return x.T, y.T, index


def test_two_process_feed_matches_single_process(tmp_path):
    store = str(tmp_path / "grid.zarr")
    x, y, index = _write_store(store)
    out, ladder, n1, n_cells, _ = dry_run(store, cell_mesh(["cpu"] * 8), sample_per_shard=M, quantiles=Q)
    single, lad1 = out.gather()[:n_cells], ladder.numpy()
    multi, (lad2, n2), meta2 = run_job(2, store, str(tmp_path / "out2"), device="cpu", shards=8,
                                       sample_per_shard=M, quantiles=Q, timeout=240)
    assert [m["process_count"] for m in meta2] == [2, 2] and meta2[0]["shards"] == 8
    assert multi.shape == (N_CELLS, N_TIME)
    npt.assert_array_equal(multi, single)  # bitwise: the same shards, the same order
    npt.assert_array_equal(lad2, lad1)
    assert n1 == n2 == int(np.isfinite(x).sum())
    assert np.isnan(multi[4]).all() and np.isfinite(np.delete(multi, 4, axis=0)).all()

    # anchored against the JAX package's batched core and its sketch
    model = BcsdTemperature(return_anoms=False)
    fg = model._fit_groups(index)
    plan = model._predict_plan(fg, index)
    want = np.asarray(bcsd_predict(bcsd_fit(x, y, fg, with_x_climo=True), x, plan,
                                   variable="temperature", return_anoms=False))
    npt.assert_allclose(multi, want, rtol=0, atol=1e-9)
    jm = jmesh.cell_mesh()
    xs, _ = jmesh.shard_cells(x, jm)
    jlad, jn = JQ.pooled_quantile_table(xs, JQ.ladder_positions(Q, jnp.float64), jm, sample_per_shard=M)
    assert int(jn) == n1
    npt.assert_allclose(lad1, np.asarray(jlad), rtol=0, atol=1e-10)
    assert torch.distributed.is_available()
