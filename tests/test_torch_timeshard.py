"""The port's time sharding (``parallel/timeshard.py``) against the JAX
package's (``tests/test_timeshard.py``'s cases) on the CPU, in float64: the
(cells, time) mesh's shape and axes, its divisibility errors, the blocks of
``shard_cells_time`` (NaN cell padding) bitwise against JAX's shards, and
QDM and BCSD run on the gathered cell rows bitwise equal to the unsharded
run and within 1e-10 of the JAX package's sharded run (the same float64
arithmetic summed in another order).  Fitted state lives per cell row.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from skdownscale_tpu.models.bcsd import bcsd_fit as j_bcsd_fit
from skdownscale_tpu.models.bcsd import bcsd_predict as j_bcsd_predict
from skdownscale_tpu.models.quantile import edcdfm_predict as j_edcdfm_predict
from skdownscale_tpu.models.quantile import qmr_fit as j_qmr_fit
from skdownscale_tpu.parallel import timeshard as jts

from skdownscale_tpu_torch.models.bcsd import BcsdTemperature, bcsd_fit, bcsd_predict
from skdownscale_tpu_torch.models.quantile import edcdfm_predict, qmr_fit
from skdownscale_tpu_torch.parallel import shard_cells_time, time_cell_mesh, time_sharding
from skdownscale_tpu_torch.parallel.mesh import map_shards

ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Drop this module's compiled JAX programs before and after it, as
    ``tests/test_torch_mbc.py`` does (one process holds every module's)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def mesh42():
    return time_cell_mesh(["cpu"] * 8, time_shards=2)


@pytest.fixture(scope="module")
def jmesh42():
    assert len(jax.devices()) == 8
    return jts.time_cell_mesh(jax.devices()[:8], time_shards=2)


def _run_sharded(mesh, step, *arrays):
    """``step`` on each cell row of the time-sharded ``arrays``: the row's
    time shards gathered onto its first device, then gathered to the host."""
    rows = []
    for a in arrays:
        ts, _ = shard_cells_time(a, mesh)
        rows.append(ts.gather_rows())
    out = rows[0].map(lambda *r: step(*r), *rows[1:])
    return out.gather(), out


def test_mesh_shape_and_axes(mesh42, jmesh42):
    assert tuple(mesh42.shape.values()) == jmesh42.devices.shape == (4, 2)
    assert mesh42.axis_names == tuple(jmesh42.axis_names) == ("cells", "time")
    assert time_sharding(mesh42).spec == tuple(jts.time_sharding(jmesh42).spec)
    assert time_sharding(mesh42, 3).spec == tuple(jts.time_sharding(jmesh42, 3).spec)


def test_qdm_matches_single_device(rng, mesh42, jmesh42):
    C, Tf, Tq = 8, 730, 366
    x = 284 + rng.normal(0, 2, (C, Tf))
    y = 283 + rng.normal(0, 1.8, (C, Tf))
    xq = 284.5 + rng.normal(0, 2, (C, Tq))

    def step(a, b, q):
        return edcdfm_predict(qmr_fit(a, b, extrapolate="both"), q, kind="difference", extrapolate="both")

    got, _ = _run_sharded(mesh42, step, x, y, xq)
    single = step(*(torch.from_numpy(v) for v in (x, y, xq))).numpy()
    npt.assert_array_equal(got, single)

    def jstep(a, b, q):
        return j_edcdfm_predict(j_qmr_fit(a, b, extrapolate="both"), q, kind="difference", extrapolate="both")

    sh = jts.time_sharding(jmesh42)
    want = jax.jit(jstep, in_shardings=(sh, sh, sh), out_shardings=sh)(
        *(jax.device_put(jnp.asarray(v), sh) for v in (x, y, xq)))
    npt.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_bcsd_matches_single_device(rng, mesh42, jmesh42):
    idx = pd.date_range("1990-01-01", "1999-12-01", freq="MS")
    C, T = 8, len(idx)
    x = 284 + rng.normal(0, 2, (C, T))
    y = 283 + rng.normal(0, 1.8, (C, T))
    model = BcsdTemperature(return_anoms=False)
    fg = model._fit_groups(idx)
    plan = model._predict_plan(fg, idx)

    def step(xx, yy):
        return bcsd_predict(bcsd_fit(xx, yy, fg, with_x_climo=True), xx, plan, return_anoms=False)

    got, _ = _run_sharded(mesh42, step, x, y)
    npt.assert_array_equal(got, step(torch.from_numpy(x), torch.from_numpy(y)).numpy())

    import skdownscale_tpu.models.bcsd as JB

    jm = JB.BcsdTemperature(return_anoms=False)
    jfg = jm._fit_groups(idx)
    jplan = jm._predict_plan(jfg, idx)
    sh = jts.time_sharding(jmesh42)
    want = jax.jit(
        lambda xx, yy: j_bcsd_predict(j_bcsd_fit(xx, yy, jfg, with_x_climo=True), xx, jplan,
                                      variable="temperature", return_anoms=False),
        in_shardings=(sh, sh), out_shardings=sh,
    )(jax.device_put(jnp.asarray(x), sh), jax.device_put(jnp.asarray(y), sh))
    npt.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_fitted_state_lives_per_cell_row(rng, mesh42):
    """Each device holds a (C/4, T/2) block of the input; a row's state
    comes out on the row's first device, one state a cell row, as the
    module says (GSPMD could keep it split over both axes)."""
    C, Tf = 8, 730
    x = 284 + rng.normal(0, 2, (C, Tf))
    y = 283 + rng.normal(0, 1.8, (C, Tf))
    (xs, _), (ys, _) = shard_cells_time(x, mesh42), shard_cells_time(y, mesh42)
    assert all(b.shape == (2, 365) for b in xs.blocks)
    rows_x, rows_y = xs.gather_rows(), ys.gather_rows()
    assert rows_x.mesh.size == 4 and all(r.shape == (2, Tf) for r in rows_x.shards)
    states = map_shards(lambda a, b: qmr_fit(a, b, extrapolate="both"), rows_x, rows_y)
    assert len(states) == 4
    for st in states:
        assert all(leaf.shape[0] == 2 for leaf in st)


def test_shard_cells_time_pads_and_validates(rng, mesh42, jmesh42):
    arr = rng.normal(size=(7, 10))
    sharded, n = shard_cells_time(arr, mesh42)
    want, wn = jts.shard_cells_time(arr, jmesh42)
    assert n == wn == 7 and sharded.shape == want.shape == (8, 10)
    got = sharded.gather()
    assert np.isnan(got[7:]).all()
    npt.assert_array_equal(got, np.asarray(want))
    order = {d: i for i, d in enumerate(jmesh42.devices.reshape(-1))}
    jblocks = sorted(want.addressable_shards, key=lambda s: order[s.device])
    for b, w in zip(sharded.blocks, jblocks):
        npt.assert_array_equal(b.numpy(), np.asarray(w.data))
    with pytest.raises(ValueError, match="time shards"):
        shard_cells_time(rng.normal(size=(8, 11)), mesh42)


def test_time_cell_mesh_divisibility():
    with pytest.raises(ValueError, match="divisible"):
        time_cell_mesh(["cpu"] * 8, time_shards=3)
    with pytest.raises(ValueError, match="divisible"):
        jts.time_cell_mesh(jax.devices()[:8], time_shards=3)
