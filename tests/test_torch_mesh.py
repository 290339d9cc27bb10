"""The port's multi-device layer against the JAX package's on the CPU, in
float64: the mesh splits (``shard_cells``, ``host_cell_slice``,
``cell_sharding``) bitwise; ``PointWiseDownscaler(sharding=)`` (BCSD dense,
streaming and daily, the quantile family, GARD's sampled analogs) against
the JAX runner on its 8 virtual devices and bitwise against the port's own
unsharded run; the pooled quantile sketch against JAX's ``_sketch_ladder``
(an empty shard and tied data included); ``GlobalDownscaler`` with both
global models on a mesh; ``mbcn_grid(sharding=)``; checkpoints saved on 8
shards and loaded on 1, and the reverse.

The port's mesh of ``["cpu"] * 8`` stands in for the JAX package's 8
virtual CPU devices (``tests/conftest.py``).  JAX's ``device_put`` needs
the valid cell count to divide the mesh, so the runner is held against JAX
at 24 valid cells; the port's uneven split (``ceil(n / 8)`` cells a shard,
the last shards short or empty) is held bitwise against its unsharded run.

Tolerance: ``atol = 1e-10`` against JAX (the same float64 arithmetic,
summed in another order); cell-local paths bitwise against the port's
unsharded run.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

import skdownscale_tpu as J
import skdownscale_tpu.global_models.quantile as JQ
from skdownscale_tpu.models import batched as jb
from skdownscale_tpu.models.mbc import mbcn_grid as j_mbcn_grid
from skdownscale_tpu.parallel import mesh as jmesh
from skdownscale_tpu.parallel import multihost as jmh
from skdownscale_tpu.xlite import DataArray as JDA
from skdownscale_tpu.xlite import Dataset as JDS

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.global_models.quantile as PQ
import skdownscale_tpu_torch.utils.checkpoint as CK
from skdownscale_tpu_torch.models import batched as pb
from skdownscale_tpu_torch.models.base import SingleCellEstimator
from skdownscale_tpu_torch.models.mbc import mbcn_grid as p_mbcn_grid
from skdownscale_tpu_torch.parallel import mesh as pmesh
from skdownscale_tpu_torch.parallel import (
    cell_mesh,
    cell_sharding,
    feed_cells,
    host_cell_slice,
    shard_cells,
)
from skdownscale_tpu_torch.xlite import DataArray as PDA
from skdownscale_tpu_torch.xlite import Dataset as PDS

ATOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Drop this module's compiled JAX programs before and after it, as
    ``tests/test_torch_mbc.py`` does (one process holds every module's)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def single_cell_on_cpu(monkeypatch):
    monkeypatch.setattr(SingleCellEstimator, "single_cell_device", torch.device("cpu"))


@pytest.fixture(scope="module")
def mesh8():
    return cell_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) == 8
    return jmesh.cell_mesh()


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_allclose(got, want, rtol=0, atol=atol)


def _bitwise(got, want):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    npt.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,tail", [(16, ()), (20, (3,)), (7, ()), (1, (2, 2))])
def test_shard_cells_splits_as_jax(rng, mesh8, jmesh8, n, tail):
    arr = rng.normal(size=(n, *tail))
    got, gn = shard_cells(arr, mesh8)
    want, wn = jmesh.shard_cells(arr, jmesh8)
    assert gn == wn == n and got.shape == want.shape
    order = {d: i for i, d in enumerate(jmesh8.devices.reshape(-1))}
    jshards = sorted(want.addressable_shards, key=lambda s: order[s.device])
    assert len(got.shards) == len(jshards) == 8
    for g, w in zip(got.shards, jshards):
        _bitwise(g.numpy(), np.asarray(w.data))
    _bitwise(got.gather(), np.asarray(want))


@pytest.mark.parametrize("n", [16, 20, 7, 3])
@pytest.mark.parametrize("procs", [1, 2, 4])
def test_host_cell_slice_and_feed_cells_as_jax(rng, mesh8, monkeypatch, n, procs):
    for rank in range(procs):
        m = pmesh.CellMesh(["cpu"] * (8 // procs))
        m.rank, m.world, m.size = rank, procs, 8
        monkeypatch.setattr(jmh.jax, "process_count", lambda: procs)
        monkeypatch.setattr(jmh.jax, "process_index", lambda: rank)
        got, want = host_cell_slice(n, m), jmh.host_cell_slice(n, jmesh.cell_mesh())
        assert (got.start, got.stop) == (want.start, want.stop)
    monkeypatch.undo()
    arr = rng.normal(size=(n, 5))
    sc, nn = feed_cells(arr, n, mesh8)
    ref, _ = shard_cells(arr, mesh8)
    assert nn == n and sc.shape == ref.shape
    _bitwise(sc.gather(), ref.gather())


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_cell_sharding_spec_as_jax(mesh8, jmesh8, ndim):
    got = cell_sharding(mesh8, ndim)
    assert got.mesh is mesh8
    assert got.spec == tuple(jmesh.cell_sharding(jmesh8, ndim).spec)
    assert pmesh.as_mesh(got) is mesh8 and pmesh.as_mesh(mesh8) is mesh8


def test_cell_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        cell_mesh()
    m = cell_mesh(["cpu"] * 3, axis_name="x")
    assert (m.size, m.shape, m.axis_names, m.group, list(m.local_shards)) == (3, {"x": 3}, ("x",), None, [0, 1, 2])
    with pytest.raises(TypeError, match="CellMesh"):
        pmesh.as_mesh(object())


def test_collectives_in_mesh_order(mesh8):
    parts = [torch.full((3,), float(k)) + torch.arange(3) for k in range(8)]
    g = pmesh.all_gather(parts, mesh8)
    assert g.shape == (8, 3)
    _bitwise(g.numpy(), np.stack([p.numpy() for p in parts]))
    want = parts[0].clone()
    for p in parts[1:]:
        want += p
    _bitwise(pmesh.all_reduce(parts, mesh8).numpy(), want.numpy())
    assert pmesh.split_sizes(21, 8) == [3, 3, 3, 3, 3, 3, 3, 0]
    assert pmesh.split_sizes(5, 8) == [1, 1, 1, 1, 1, 0, 0, 0]


# ---------------------------------------------------------------------------
# PointWiseDownscaler on a mesh
# ---------------------------------------------------------------------------


def _grid(rng, DA, kind, n_valid):
    """(X, Y) on (time, lat, lon) with ``n_valid`` valid cells of 4 x 7."""
    if kind == "daily":
        idx = pd.date_range("1990-01-01", periods=3 * 365, freq="D")
        seas = 10 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25)
    elif kind == "quantile":
        idx = pd.date_range("1990-01-01", periods=400, freq="D")
        seas = 10 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25)
    else:
        idx = pd.date_range("1980-01-01", periods=120, freq="MS")
        seas = 8 * np.sin(2 * np.pi * (idx.month.to_numpy() - 1) / 12)
    T, C = len(idx), 28
    x = 284.5 + seas[:, None] + rng.normal(0, 2, (T, C))
    y = 282.0 + seas[:, None] + rng.normal(0, 1.8, (T, C))
    dead = np.sort(np.random.default_rng(5).choice(C, C - n_valid, replace=False))
    x[:, dead] = y[:, dead] = np.nan
    coords = {"time": idx, "lat": np.arange(4), "lon": np.arange(7)}
    return tuple(DA(a.reshape(T, 4, 7), ("time", "lat", "lon"), coords) for a in (x, y))


_MODELS = {
    "bcsd": lambda M: M.BcsdTemperature(return_anoms=False),
    "bcsd_anoms": lambda M: M.BcsdTemperature(),
    "daily": lambda M: M.BcsdTemperature(time_grouper="daily_nasa-nex", return_anoms=False),
    "quantile": lambda M: M.TrendAwareQuantileMappingRegressor(M.QuantileMappingReressor(extrapolate="both")),
    "sample_analogs": lambda M: M.PureAnalog(n_analogs=6, kind="sample_analogs", random_state=0),
}


@pytest.mark.parametrize("name,streaming", [("bcsd", False), ("bcsd", True), ("bcsd_anoms", False),
                                            ("daily", False), ("quantile", False)])
def test_pointwise_on_a_mesh_matches_jax(rng, mesh8, jmesh8, monkeypatch, name, streaming):
    kind = name if name in ("daily", "quantile") else "monthly"
    seed = int(rng.integers(1 << 30))
    X, Y = _grid(np.random.default_rng(seed), PDA, kind, 24)
    JX, JY = _grid(np.random.default_rng(seed), JDA, kind, 24)
    if streaming:  # the monthly streaming form
        monkeypatch.setattr(pb, "STREAMING_CELL_THRESHOLD", 4)
        monkeypatch.setattr(jb, "STREAMING_CELL_THRESHOLD", 4)
    d = P.PointWiseDownscaler(_MODELS[name](P), sharding=mesh8).fit(X, Y)
    got = d.predict(X).values
    want = J.PointWiseDownscaler(_MODELS[name](J), sharding=jmesh8).fit(JX, JY).predict(JX).values
    _close(got, want)
    assert d.sharding is mesh8 and len(d._state) == 1 and len(d._state[0]) == 8
    lazy = isinstance(d._state[0][0], P.models.bcsd.BcsdLazyState)
    assert lazy == (streaming or name == "daily") or name == "quantile"
    one = P.PointWiseDownscaler(_MODELS[name](P), device="cpu").fit(X, Y)
    _bitwise(got, one.predict(X).values)


@pytest.mark.parametrize("name", ["bcsd", "daily", "quantile", "sample_analogs"])
@pytest.mark.parametrize("n_valid,chunk", [(21, None), (21, 10), (5, None)])
def test_pointwise_uneven_shards_bitwise_unsharded(rng, mesh8, name, n_valid, chunk):
    kind = "daily" if name == "daily" else "quantile" if name in ("quantile", "sample_analogs") else "monthly"
    X, Y = _grid(rng, PDA, kind, n_valid)
    d = P.PointWiseDownscaler(_MODELS[name](P), sharding=cell_sharding(mesh8, 3), cell_chunk_size=chunk).fit(X, Y)
    one = P.PointWiseDownscaler(_MODELS[name](P), device="cpu", cell_chunk_size=chunk).fit(X, Y)
    assert [[s is None for s in st] for st in d._state] == [
        [n == 0 for n in pmesh.split_sizes(len(ids), 8)] for ids in d._state_plan]
    _bitwise(d.predict(X).values, one.predict(X).values)
    if name != "quantile":
        key = "k_" if name == "sample_analogs" else "y_climo_"
        _bitwise(d.get_attr(key).values, one.get_attr(key).values)


# ---------------------------------------------------------------------------
# the pooled quantile sketch
# ---------------------------------------------------------------------------


def _sketch_pair(vals, pp, mesh8, jmesh8, m):
    got, gn = PQ.pooled_quantile_table(torch.from_numpy(vals), torch.tensor(np.asarray(pp)), mesh8,
                                       sample_per_shard=m)
    vs, _ = jmesh.shard_cells(vals, jmesh8)
    want, wn = JQ.pooled_quantile_table(vs, pp, jmesh8, sample_per_shard=m)
    assert int(gn) == int(wn) == int(np.isfinite(vals).sum())
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("C,T,nan,m,Q", [(64, 512, 0.05, 2048, 129), (20, 300, 0.1, 64, 257), (8, 30, 0.0, 1000, 65)])
def test_sketch_matches_jax(rng, mesh8, jmesh8, C, T, nan, m, Q):
    vals = rng.normal(0, 1, (C, T))
    vals[rng.random((C, T)) < nan] = np.nan
    got, want = _sketch_pair(vals, JQ.ladder_positions(Q, jnp.float64), mesh8, jmesh8, m)
    _close(got, want)
    exact, _ = PQ.pooled_quantile_table(torch.from_numpy(vals), torch.tensor(np.asarray(JQ.ladder_positions(Q))))
    assert not np.array_equal(got, exact.numpy())  # the mesh took the sketch


def test_sketch_empty_shard_matches_jax(rng, mesh8, jmesh8):
    C, T = 16, 64
    vals = rng.normal(0, 1, (C, T))
    vals[:2] = np.nan  # shard 0 all-NaN: zero weight, no pollution
    got, want = _sketch_pair(vals, JQ.ladder_positions(65, jnp.float64), mesh8, jmesh8, 512)
    _close(got, want)
    assert np.isfinite(got).all()


def test_sketch_tied_data_matches_jax_and_the_tie_order_matters(rng, mesh8, jmesh8):
    """Values rounded to 0.1 and shards of unequal counts: samples of one
    value carry other weights in other shards.  The port's stable sort
    orders a tie by mesh order, as JAX's CPU ``lax.sort`` does; the reverse
    order moves the ladder."""
    C, T = 24, 200
    vals = np.round(rng.normal(0, 1, (C, T)), 1)
    vals[rng.random((C, T)) < np.repeat(np.linspace(0, 0.6, 8), 3)[:, None]] = np.nan
    pp = JQ.ladder_positions(257, jnp.float64)
    got, want = _sketch_pair(vals, pp, mesh8, jmesh8, 128)
    _close(got, want)
    # the same merge with each tie in reverse mesh order
    sc, _ = shard_cells(vals, mesh8)
    all_s, all_w = [], []
    for v in sc.shards:
        flat = torch.where(torch.isfinite(v), v, float("inf")).reshape(-1)
        cnt = torch.isfinite(v).sum().double()
        s = torch.sort(flat).values
        j = torch.arange(128, dtype=torch.float64)
        r = torch.minimum(torch.clamp((j + 0.5) * cnt / 128, min=0), torch.clamp(cnt - 1, min=0)).long()
        all_s.append(s[r])
        all_w.append((cnt / 128).expand(128))
    vv, ww = torch.cat(all_s[::-1]), torch.cat(all_w[::-1])
    rev = PQ._ladder_from_weighted(vv, ww, torch.tensor(np.asarray(pp))).numpy()
    assert np.abs(rev - want).max() > 1e-6


def test_sketch_float32_matches_jax(rng, mesh8, jmesh8):
    vals = rng.normal(280, 5, (32, 400)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.05] = np.nan
    pp = JQ.ladder_positions(129, jnp.float32)
    got, want = _sketch_pair(vals, pp, mesh8, jmesh8, 256)
    assert got.dtype == want.dtype == np.float32
    _close(got, want, atol=1e-4)  # float32 cumsum of the weights in another order


# ---------------------------------------------------------------------------
# GlobalDownscaler, mbcn_grid and checkpoints on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "cell_linear", "quantile"])
def test_global_downscaler_on_a_mesh_matches_jax(rng, mesh8, jmesh8, kind):
    idx = pd.date_range("1990-01-01", periods=150, freq="D")
    x = 10 + rng.normal(0, 3, (150, 4, 5))
    x[:, 0, 0] = np.nan  # ocean cell
    x[rng.random(x.shape) < 0.03] = np.nan
    y = x * 0.9 - 1.0 + rng.normal(0, 0.5, x.shape) + np.arange(5) * 0.3
    coords = {"time": idx, "y": np.arange(4), "x": np.arange(5)}
    dims = ("time", "y", "x")

    def make(M):
        if kind == "quantile":
            return M.GlobalQuantileMapper(n_quantiles=64, sample_per_shard=256)
        return M.GlobalLinearRegressor(cell_intercepts=kind == "cell_linear")

    pd_ = P.GlobalDownscaler(make(P), sharding=mesh8).fit(PDA(x, dims, coords), PDA(y, dims, coords))
    jd = J.GlobalDownscaler(make(J), sharding=jmesh8).fit(JDA(x, dims, coords), JDA(y, dims, coords))
    method = "transform" if kind == "quantile" else "predict"
    got = getattr(pd_, method)(PDA(x, dims, coords))
    want = getattr(jd, method)(JDA(x, dims, coords))
    assert got.dims == want.dims == ("y", "x", "time")
    _close(got.values, want.values)
    st, jst = pd_._model.state_, jd._model.state_
    if kind == "quantile":
        assert pd_._model.mesh is mesh8
        _close(st.x_ladder.numpy(), jst.x_ladder)
        _close(st.y_ladder.numpy(), jst.y_ladder)
        _close(pd_.inverse_transform(PDA(y, dims, coords)).values, jd.inverse_transform(JDA(y, dims, coords)).values)
        # the transform is the unsharded transform through the same ladder
        one = P.GlobalQuantileMapper(n_quantiles=64, device="cpu")
        one.state_ = st
        flat = np.moveaxis(x, 0, -1).reshape(20, 150)
        _bitwise(np.moveaxis(got.values, -1, 0).reshape(150, 20).T, one.transform(flat).numpy())
    else:
        _close(st.coef.numpy(), jst.coef)
        _close(st.intercept.numpy(), jst.intercept)
        _close(st.cell_intercept.gather()[:20], np.asarray(jst.cell_intercept)[:20])
        assert int(st.n_samples) == int(jst.n_samples)
        one = P.GlobalDownscaler(make(P), device="cpu").fit(PDA(x, dims, coords), PDA(y, dims, coords))
        _close(got.values, one.predict(PDA(x, dims, coords)).values)


def _mbcn_grids(DA, DS, ny=4, nx=4, tm=180, to=200, tf=150):
    def ds(T, loc, start, nan_sample):
        idx = pd.date_range(start, periods=T, freq="D")
        coords = {"time": idx, "y": np.arange(ny), "x": np.arange(nx)}
        das = {}
        for j, v in enumerate(("tmax", "pr")):
            a = np.random.default_rng(j + T).normal(loc + j, 1.5, (T, ny, nx))
            a[:, 0, 0] = np.nan
            if nan_sample and j == 1:
                a[3, 2, 1] = np.nan
            das[v] = DA(a, ("time", "y", "x"), coords)
        return DS(das)

    return ds(to, 0.0, "1980-01-01", False), ds(tm, 1.0, "1981-01-01", True), ds(tf, 1.3, "2050-01-01", False)


@pytest.mark.parametrize("chunk", [None, 5])
def test_mbcn_grid_on_a_mesh(mesh8, jmesh8, chunk):
    """``tests/test_mbc.py``'s sharded run (4 x 4 cells, 3 rotations)."""
    jy, jxh, jxf = _mbcn_grids(JDA, JDS)
    py, pxh, pxf = _mbcn_grids(PDA, PDS)
    want = j_mbcn_grid(jy, jxh, jxf, n_iterations=3, cell_chunk_size=chunk,
                       sharding=NamedSharding(jmesh8, JP("cells", None, None)))
    got = p_mbcn_grid(py, pxh, pxf, n_iterations=3, cell_chunk_size=chunk, sharding=cell_sharding(mesh8, 3))
    one = p_mbcn_grid(py, pxh, pxf, n_iterations=3, cell_chunk_size=chunk, device="cpu")
    for g, w, o in zip(got, want, one):
        for v in ("tmax", "pr"):
            _close(g[v].values, w[v].values)
            _bitwise(g[v].values, o[v].values)


@pytest.mark.parametrize("name", ["bcsd", "daily", "quantile"])
def test_checkpoint_8_to_1_and_1_to_8(rng, mesh8, tmp_path, name):
    kind = name if name in ("daily", "quantile") else "monthly"
    X, Y = _grid(rng, PDA, kind, 21)
    sharded = P.PointWiseDownscaler(_MODELS[name](P), sharding=mesh8, cell_chunk_size=12).fit(X, Y)
    single = P.PointWiseDownscaler(_MODELS[name](P), device="cpu", cell_chunk_size=12).fit(X, Y)
    want = single.predict(X).values
    CK.save(str(tmp_path / "s8.npz"), sharded)
    CK.save(str(tmp_path / "s1.npz"), single)
    with np.load(tmp_path / "s8.npz") as a, np.load(tmp_path / "s1.npz") as b:  # one format
        assert a.files == b.files
        for k in a.files:
            _bitwise(a[k], b[k])
    back1 = CK.load(str(tmp_path / "s8.npz"), device="cpu")
    assert back1.sharding is None
    _bitwise(back1.predict(X).values, want)
    back8 = CK.load(str(tmp_path / "s1.npz"), sharding=mesh8)
    assert back8.sharding is mesh8 and len(back8._state[0]) == 8
    _bitwise(back8.predict(X).values, want)
    back3 = CK.load(str(tmp_path / "s8.npz"), sharding=cell_mesh(["cpu"] * 3))
    _bitwise(back3.predict(X).values, want)


def test_split_cells_refuses_a_leaf_without_the_cell_axis():
    st = pb.GardState(torch.zeros(4, 3, 1), torch.zeros(5, 3))
    with pytest.raises(ValueError, match="leading axis of 4 cells"):
        pb.split_cells(st, [2, 2])
    parts = pb.split_cells(P.models.bcsd.BcsdState(torch.arange(6, dtype=torch.float64), torch.zeros(4, 6), torch.ones(4, 8)), [3, 1])
    assert [p.vals.shape[0] for p in parts] == [3, 1] and all(p.pp.shape == (6,) for p in parts)
    whole = pb.cat_cells(parts)
    _bitwise(whole.pp.numpy(), np.arange(6.0))
    assert whole.vals.shape == (4, 6)
