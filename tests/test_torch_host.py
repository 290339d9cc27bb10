"""Host code copied into the port equals the JAX package's, bitwise: group
tables, predict plans, rank-bracket and tail tables, the rolling matrix,
calendars, xlite, the native packer binding and the prefetching feed.  Also
the port's import hygiene: no jax, no skdownscale_tpu."""

import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest

import skdownscale_tpu.models.bcsd as jb
import skdownscale_tpu.models.grouped as jg
import skdownscale_tpu.ops.rolling as jr
import skdownscale_tpu.utils.native as jn
import skdownscale_tpu.utils.timeindex as jt
import skdownscale_tpu.xlite as jx

import skdownscale_tpu_torch.models.bcsd as pb
import skdownscale_tpu_torch.models.grouped as pg
import skdownscale_tpu_torch.ops.rolling as pr
import skdownscale_tpu_torch.utils.native as pn
import skdownscale_tpu_torch.utils.timeindex as pt
import skdownscale_tpu_torch.xlite as px
from skdownscale_tpu_torch.utils.prefetch import prefetched


def _groups_equal(a, b):
    for f in ("indices", "mask", "counts", "keys", "labels"):
        ga, gb = getattr(a, f), getattr(b, f)
        assert (ga is None) == (gb is None), f
        if ga is not None:
            npt.assert_array_equal(ga, gb, err_msg=f)
            assert ga.dtype == gb.dtype, f


def test_import_has_no_jax():
    """Every submodule of the port imports, the z-score, ARRM, grouping,
    global-model and device-layer modules (the meshes, multi-process
    feeding, time sharding and the dry run among them), the store layer,
    the pipeline, the utilities, the CLI, the migration shim and the
    examples among them, and none of them pulls in jax or the JAX package
    (importing an example runs nothing)."""
    code = (
        "import importlib, pkgutil, sys, skdownscale_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, 'skdownscale_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'skdownscale_tpu' or m.startswith('skdownscale_tpu.')]\n"
        "need = ['models.zscore', 'models.arrm', 'models.grouping', 'parallel.mesh',"
        " 'global_models.linear', 'global_models.quantile', 'global_models.downscaler',"
        " 'utils.zarrlite', 'utils.profiling', 'utils.checkpoint', 'utils.metrics',"
        " 'utils.disagg', 'parallel.zarr_io', 'parallel.pipeline', 'parallel.multihost',"
        " 'parallel.timeshard', 'parallel.dryrun', 'cli', 'pointwise_models', 'examples.utils',"
        " 'examples.bcsd_example', 'examples.gard_example', 'examples.mbcn_example',"
        " 'examples.global_models_example', 'examples.sharded_grid', 'examples.full_bcsd_pipeline',"
        " 'examples.continental_bcsd', 'examples.tutorial', 'examples.make_tutorial_notebook',"
        " 'examples.make_analog_notebook']\n"
        "missing = [n for n in need if 'skdownscale_tpu_torch.' + n not in names]\n"
        "print(len(names), bad, missing)\n"
        "raise SystemExit(1 if bad or missing or len(names) < 56 else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_single_cell_device_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """The single-cell API runs on the card unless the caller asks for the
    CPU; without a card it raises, saying how to ask, and never continues on
    the CPU."""
    import torch

    import skdownscale_tpu_torch as P
    from skdownscale_tpu_torch.models.base import SingleCellEstimator

    assert SingleCellEstimator.single_cell_device == torch.device("cuda")
    X = pd.DataFrame({"t": np.linspace(280.0, 290.0, 60)},
                     index=pd.date_range("1990-01-01", periods=60, freq="MS"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for est, args in ((P.BcsdTemperature(), (X, X)), (P.QuantileMappingReressor(), (X, X)),
                      (P.QuantileMapper(), (X,)), (P.LinearTrendTransformer(), (X,))):
        assert est._cell_device  # shared by every wrapper
        with pytest.raises(RuntimeError, match="single_cell_device = torch.device\\('cpu'\\)"):
            est.fit(*args)
    monkeypatch.setattr(SingleCellEstimator, "single_cell_device", torch.device("cpu"))
    got = P.QuantileMappingReressor().fit(X, X)._X_cdf.vals
    assert got.dtype == np.float64


_INDEXES = {
    "monthly_40y": pd.date_range("1970-01-01", periods=480, freq="MS"),
    "monthly_ragged": pd.date_range("1983-04-01", periods=137, freq="MS"),
    "daily_2y": pd.date_range("2000-01-01", periods=731, freq="D"),
}


@pytest.mark.parametrize("name", sorted(_INDEXES))
@pytest.mark.parametrize("grouper", ["MONTH_GROUPER", "DAY_GROUPER"])
def test_pandas_partition_bitwise(name, grouper):
    idx = _INDEXES[name]
    _groups_equal(
        pb._pandas_partition(idx, getattr(pb, grouper)),
        jb._pandas_partition(idx, getattr(jb, grouper)),
    )


def test_pandas_partition_timeindex_bitwise():
    y = np.repeat(np.arange(1990, 2000), 12)
    m = np.tile(np.arange(1, 13), 10)
    d = np.full(120, 15)
    for cal in ("noleap", "360_day", "standard"):
        a = pt.TimeIndex.from_components(y, m, d, calendar=cal)
        b = jt.TimeIndex.from_components(y, m, d, calendar=cal)
        for f in ("month", "day", "dayofyear", "year", "is_leap_year"):
            npt.assert_array_equal(getattr(a, f), getattr(b, f))
        _groups_equal(pb._pandas_partition(a, "M"), jb._pandas_partition(b, "M"))
        _groups_equal(
            pb._pandas_partition(a, pb.MONTH_GROUPER), jb._pandas_partition(b, jb.MONTH_GROUPER)
        )


@pytest.mark.parametrize("fit,pred", [("monthly_40y", "monthly_ragged"), ("monthly_40y", "monthly_40y")])
def test_predict_plan_and_inverse_perm_bitwise(fit, pred):
    pm, jm = pb.BcsdTemperature(), jb.BcsdTemperature()
    pfg, jfg = pm._fit_groups(_INDEXES[fit]), jm._fit_groups(_INDEXES[fit])
    _groups_equal(pfg, jfg)
    pp, jp = pm._predict_plan(pfg, _INDEXES[pred]), jm._predict_plan(jfg, _INDEXES[pred])
    for f in ("fit", "transform", "rolling"):
        _groups_equal(getattr(pp, f), getattr(jp, f))
    for f in ("transform_to_fit", "shift_labels", "anom_labels"):
        npt.assert_array_equal(getattr(pp, f), getattr(jp, f))
        assert getattr(pp, f).dtype == getattr(jp, f).dtype
    n = len(_INDEXES[pred])
    for f in ("transform", "rolling"):
        npt.assert_array_equal(pg._inverse_perm(getattr(pp, f), n), jg._inverse_perm(getattr(jp, f), n))
    assert pg._inverse_perm(pp.transform, n + 1) is None


@pytest.mark.parametrize("alpha,beta", [(0.4, 0.4), (0.0, 1.0), (0.5, 0.5)])
def test_rank_bracket_tail_and_pp_tables_bitwise(alpha, beta):
    rng = np.random.default_rng(3)
    fit_counts = rng.integers(1, 41, 12).astype(np.int32)
    q_counts = rng.integers(1, 35, 12).astype(np.int32)
    q_pp = jg._padded_pp_from_counts(q_counts, 40, alpha, beta)
    npt.assert_array_equal(pg._padded_pp_from_counts(q_counts, 40, alpha, beta), q_pp)
    a = pg.rank_bracket_tables(fit_counts, q_pp, 40, alpha=alpha, beta=beta)
    b = jg.rank_bracket_tables(fit_counts, q_pp, 40, alpha=alpha, beta=beta)
    assert sorted(a) == sorted(b)
    for k in a:
        npt.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    for ne in (10, 50):
        for u, v in zip(pg._tail_windows(fit_counts, 40, ne), jg._tail_windows(fit_counts, 40, ne)):
            npt.assert_array_equal(u, v)
    g = pb._pandas_partition(_INDEXES["monthly_ragged"], pb.MONTH_GROUPER)
    npt.assert_array_equal(pg._padded_pp(g, alpha, beta), jg._padded_pp(g, alpha, beta))


@pytest.mark.parametrize("name", ["monthly_40y", "monthly_ragged"])
@pytest.mark.parametrize("window", [9, 4])
def test_grouped_rolling_matrix_bitwise(name, window):
    idx = _INDEXES[name]
    g = pb._pandas_partition(idx, pb.MONTH_GROUPER)
    jg_ = jb._pandas_partition(idx, jb.MONTH_GROUPER)
    npt.assert_array_equal(
        pr.grouped_rolling_matrix(g, window, len(idx)),
        jr.grouped_rolling_matrix(jg_, window, len(idx)),
    )
    assert pr.grouped_rolling_matrix(g, window, len(idx) + 1) is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_binding_matches(rng, dtype):
    src = rng.normal(size=(30, 2, 50)).astype(dtype)
    src[:, :, [3, 17]] = np.nan
    ids = np.array([0, 1, 2, 4, 9, 49], np.int32)
    npt.assert_array_equal(pn.pack_compact(src, ids), jn.pack_compact(src, ids))
    packed = pn.pack_compact(src, ids)
    npt.assert_array_equal(
        pn.unpack_scatter(packed, ids, 50), jn.unpack_scatter(packed, ids, 50)
    )
    npt.assert_array_equal(pn.valid_mask(src[0, 0]), jn.valid_mask(src[0, 0]))
    # the numpy fallback of the port gives the same result as its native path
    npt.assert_array_equal(np.moveaxis(src, 2, 0)[ids], pn.pack_compact(src, ids))


def test_xlite_matches(rng):
    data = rng.normal(size=(4, 3, 5))
    coords = {"time": np.arange(4), "y": np.arange(3), "x": np.arange(5)}
    a = px.DataArray(data, ("time", "y", "x"), coords)
    b = jx.DataArray(data, ("time", "y", "x"), coords)
    for f in (
        lambda d: d.transpose("x", "time", "y"),
        lambda d: d.expand_dims("variable", ["v0"], axis=1),
        lambda d: d.isel(y=1),
        lambda d: d.isel(x=[0, 2]),
    ):
        u, v = f(a), f(b)
        assert u.dims == v.dims
        npt.assert_array_equal(u.values, v.values)
        assert sorted(u.coords) == sorted(v.coords)
    ds_a = px.Dataset({"p": a, "q": a}).to_array()
    ds_b = jx.Dataset({"p": b, "q": b}).to_array()
    assert ds_a.dims == ds_b.dims
    npt.assert_array_equal(ds_a.values, ds_b.values)
    assert px.is_dataarray(a) and not px.is_dataset(a)
    assert px.is_dataset(px.Dataset({"p": a}))


def test_prefetched_keeps_order_and_raises_in_place():
    assert list(prefetched(range(5), lambda i: i * i)) == [0, 1, 4, 9, 16]
    assert list(prefetched([], lambda i: i)) == []

    def prep(i):
        if i == 2:
            raise RuntimeError("boom")
        return i

    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for v in prefetched(range(4), prep):
            got.append(v)
    assert got == [0, 1]
