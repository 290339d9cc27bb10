"""The port's store layer against the JAX package's on the CPU: the native
codec bindings (blosc, zstd, crc32c), ``utils/zarrlite.py`` (the same bytes
under the same keys for every writer setting of ``tests/test_zarr_io.py``,
and each package reading the other's stores), ``parallel/zarr_io.py`` and
``parallel/pipeline.py`` (store -> device -> store).

Tolerances: the codecs, the stores, the metadata and ``time`` keys bitwise;
the pipeline bitwise against the port's own ``PointWiseDownscaler`` on the
same float32 grid, and against the JAX pipeline (float32 in both) within
the BCSD limits of ``PERF.md`` section 2 (p99.9 of |diff| <= 1e-3 K, at
most 0.1% of values above 1e-3 K, none above 5 K) and the quantile family's
(p99.9 <= 2e-3 K, at most 0.5% above 1e-3 K, none above 5 K): the two
packages round float32 sums in other orders.
"""

import struct

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax

import skdownscale_tpu.utils.native as JN
from skdownscale_tpu.parallel.pipeline import run_pointwise_pipeline as jax_pipeline
from skdownscale_tpu.parallel.zarr_io import ZarrGridSource as JSource
from skdownscale_tpu.utils import zarrlite as JZ

import skdownscale_tpu_torch as P
import skdownscale_tpu_torch.utils.native as PN
from skdownscale_tpu_torch.parallel.mesh import MULTI_DEVICE_ITEM
from skdownscale_tpu_torch.parallel.pipeline import run_pointwise_pipeline
from skdownscale_tpu_torch.parallel.zarr_io import ZarrGridSource, feed_zarr_cells
from skdownscale_tpu_torch.utils import zarrlite as PZ
from skdownscale_tpu_torch.xlite import DataArray as PDA

BCSD_LIMITS = (1e-3, 1e-3, 5.0)  # p99.9, share above 1e-3, max (K)
QUANTILE_LIMITS = (2e-3, 5e-3, 5.0)


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Drop this module's compiled JAX programs before and after it, as
    ``tests/test_torch_mbc.py`` does (one process holds every module's)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


needs_blosc = pytest.mark.skipif(not JN.blosc_available(), reason="native blosclite not built")


# ---------------------------------------------------------------------------
# native codecs
# ---------------------------------------------------------------------------


@needs_blosc
@pytest.mark.parametrize("typesize,shuffle", [(1, 0), (4, 1), (8, 1)])
def test_blosc_frames_equal_the_jax_binding(rng, typesize, shuffle):
    raw = np.round(rng.normal(0, 3, 20_000)).astype(np.float64).tobytes()
    frame = PN.blosc_compress(raw, typesize=typesize, shuffle=shuffle)
    assert frame == JN.blosc_compress(raw, typesize=typesize, shuffle=shuffle)
    assert PN.blosc_decompress(frame) == raw
    with pytest.raises(ValueError, match="malformed blosc frame"):
        PN.blosc_decompress(frame[:8] + b"\x00" * 8)


def test_crc32c_and_zstd_equal_the_jax_binding(rng):
    for n in (0, 1, 7, 64, 4097):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert PN.crc32c(data) == JN.crc32c(data) == PZ._crc32c_py(data)
    payload = b"zarr chunk payload " * 5
    bh = (len(payload) << 3) | 1  # one raw block, the last
    frame = b"\x28\xb5\x2f\xfd" + bytes([0x20, len(payload)]) + struct.pack("<I", bh)[:3] + payload
    assert PN.zstd_decompress(frame) == JN.zstd_decompress(frame) == payload
    with pytest.raises(ValueError, match="malformed zstd frame"):
        PN.zstd_decompress(frame[:-4])


# ---------------------------------------------------------------------------
# zarrlite: byte-identical stores, each package reading the other's
# ---------------------------------------------------------------------------

_SETTINGS = [
    dict(zarr_format=2, compressor=None),
    dict(zarr_format=2, compressor="zlib"),
    dict(zarr_format=2, compressor="gzip"),
    dict(zarr_format=2, compressor="blosc"),
    dict(zarr_format=3, compressor=None),
    dict(zarr_format=3, compressor="zlib"),
    dict(zarr_format=3, compressor="gzip"),
    dict(zarr_format=3, compressor="blosc"),
    dict(zarr_format=3, compressor="blosc", checksum=True),
    dict(zarr_format=3, compressor="blosc", shards=(8, 6, 10)),
    dict(zarr_format=3, compressor="zlib", shards=(8, 6, 10), checksum=True),
    dict(zarr_format=3, compressor=None, shards=(8, 6, 10), checksum=True),
    dict(zarr_format=3, compressor="zlib", transpose=(1, 0, 2), checksum=True),
    dict(zarr_format=3, compressor="blosc", transpose=(2, 0, 1)),
    dict(zarr_format=3, compressor=None, transpose=(0, 2, 1)),
]


def _settings_id(s):
    return "-".join(f"{k}={v}" for k, v in s.items()).replace(" ", "")


@pytest.mark.parametrize("setting", _SETTINGS, ids=[_settings_id(s) for s in _SETTINGS])
def test_stores_are_byte_identical_and_read_across(rng, setting):
    if setting["compressor"] == "blosc" and not JN.blosc_available():
        pytest.skip("native blosclite not built")
    a = rng.normal(280, 5, (16, 12, 10)).astype(np.float32)
    a[:4, :6, :5] = np.nan  # an all-fill inner chunk: dropped from a shard
    chunks = (4, 3, 5)
    ours, theirs = {}, {}
    PZ.save_array(ours, a, chunks=chunks, attrs={"units": "K"}, **setting)
    JZ.save_array(theirs, a, chunks=chunks, attrs={"units": "K"}, **setting)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        assert ours[key] == theirs[key], key
    npt.assert_array_equal(np.asarray(PZ.open_array(theirs)), a)
    npt.assert_array_equal(np.asarray(JZ.open_array(ours)), a)
    assert PZ.open_array(theirs).attrs == {"units": "K"}


@pytest.mark.parametrize("zarr_format", [2, 3])
def test_groups_on_disk_are_identical_and_read_across(tmp_path, rng, zarr_format):
    T, ny, nx = 24, 3, 4
    g = rng.normal(280, 5, (T, ny, nx)).astype(np.float32)
    t = np.asarray(pd.date_range("2000-01-01", periods=T, freq="MS"),
                   dtype="datetime64[ns]").view(np.int64)
    for mod, name in ((PZ, "ours"), (JZ, "theirs")):
        p = str(tmp_path / f"{name}.zarr")
        mod.save_group(p, {"gcm": g}, chunks=(T, 2, nx), compressor="zlib",
                       zarr_format=zarr_format, attrs={"title": "t"})
        mod.save_array(p, t, prefix="time", zarr_format=zarr_format,
                       attrs={"kind": "datetime64[ns]"})
    ours = PZ.FsStore(str(tmp_path / "ours.zarr"))
    theirs = JZ.FsStore(str(tmp_path / "theirs.zarr"))
    assert sorted(ours) == sorted(theirs)
    assert all(ours[k] == theirs[k] for k in ours)
    src, jsrc = ZarrGridSource(str(tmp_path / "theirs.zarr"), "gcm"), JSource(str(tmp_path / "ours.zarr"), "gcm")
    for lo, hi in ((0, 12), (3, 7), (5, 100)):
        got = src.read_cells(lo, hi, dtype=np.float32)
        assert got.dtype == np.float32 and got.flags.c_contiguous
        npt.assert_array_equal(got, jsrc.read_cells(lo, hi, dtype=np.float32))
        npt.assert_array_equal(src.read_cells(lo, hi), jsrc.read_cells(lo, hi))
    assert src.index.equals(jsrc.index) and isinstance(src.index, pd.DatetimeIndex)
    assert (src.n_time, src.spatial_shape, src.n_cells) == (T, (ny, nx), ny * nx)


def test_feed_zarr_cells_names_the_multi_device_layer():
    with pytest.raises(NotImplementedError, match=MULTI_DEVICE_ITEM):
        feed_zarr_cells({}, mesh=object())


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _monthly_store(rng, store, T=120, ny=6, nx=8, zarr_format=3):
    """gcm and obs (T, ny, nx) float32, 4 NaN cells, rows chunked in twos,
    blosc (zlib without the native library), with a ``time`` member."""
    idx = pd.date_range("1980-01-01", periods=T, freq="MS")
    s = 8 * np.sin(2 * np.pi * (idx.month.to_numpy() - 1) / 12)[:, None, None]
    g = (284.5 + s + rng.normal(0, 2, (T, ny, nx))).astype(np.float32)
    o = (282.0 + s + rng.normal(0, 1.8, (T, ny, nx))).astype(np.float32)
    for a in (g, o):
        a[:, 1, 3] = np.nan
        a[:, 4, :3] = np.nan
    comp = "blosc" if JN.blosc_available() else "zlib"
    PZ.save_group(store, {"gcm": g, "obs": o}, chunks=(T, 2, nx), compressor=comp,
                  zarr_format=zarr_format)
    tv = np.asarray(idx, dtype="datetime64[ns]").view(np.int64)
    PZ.save_array(store, tv, prefix="time", zarr_format=zarr_format,
                  attrs={"kind": "datetime64[ns]"})
    return idx, g, o


def _grid(a, idx):
    return PDA(a, ("time", "y", "x"), {"time": idx, "y": np.arange(a.shape[1]),
                                       "x": np.arange(a.shape[2])})


def _within(got, want, limits):
    p999, share_lim, max_lim = limits
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    d = np.abs(got.astype(np.float64) - want)[np.isfinite(want)]
    assert np.quantile(d, 0.999) <= p999 and np.mean(d > 1e-3) <= share_lim and d.max() <= max_lim


@pytest.mark.parametrize("store_kind", ["fs", "dict"])
def test_pipeline_equals_the_port_runner_bitwise(tmp_path, rng, store_kind):
    """3 bands of 2 rows; the output reads back with its DatetimeIndex and
    equals ``PointWiseDownscaler`` on the same float32 grid bitwise."""
    if store_kind == "fs":
        store_in, store_out = str(tmp_path / "in.zarr"), str(tmp_path / "out.zarr")
    else:
        store_in, store_out = {}, {}
    idx, g, o = _monthly_store(rng, store_in)
    rep = run_pointwise_pipeline(store_in, store_out, cell_chunk=16, device="cpu")
    assert (rep.n_cells, rep.n_valid, rep.n_chunks) == (48, 44, 3)
    assert rep.stages["pinned"] is False and rep.wall_s > 0 and "cells/s" in rep.summary()
    src = ZarrGridSource(store_out, "corrected")
    assert src.index.equals(idx) and src.spatial_shape == (6, 8)
    got = src.read_cells(0, 48, dtype=np.float32)
    model = P.PointWiseDownscaler(P.BcsdTemperature(return_anoms=False), device="cpu")
    want = model.fit(_grid(g, idx), _grid(o, idx)).predict(_grid(g, idx)).values
    assert want.dtype == np.float32
    npt.assert_array_equal(got, want.reshape(len(idx), -1).T)
    assert np.isnan(got[[11, 32, 33, 34]]).all()
    npt.assert_allclose(rep.checksum, np.nansum(got, dtype=np.float64), rtol=1e-12)


_OUT_SETTINGS = [
    dict(zarr_format=3, compressor="blosc"),
    dict(zarr_format=2, compressor="zlib"),
    dict(zarr_format=3, compressor="blosc", inner_chunks=(60, 1, 4), checksum=True),
]


@pytest.mark.parametrize("out", _OUT_SETTINGS, ids=[_settings_id(s) for s in _OUT_SETTINGS])
def test_pipeline_agrees_with_the_jax_pipeline(rng, out):
    """Within the BCSD limits; the metadata and ``time`` keys of the two
    output stores byte for byte, and the same reports' counts."""
    if out["compressor"] == "blosc" and not JN.blosc_available():
        pytest.skip("native blosclite not built")
    store = {}
    idx, _, _ = _monthly_store(rng, store)
    ours, theirs = {}, {}
    rep = run_pointwise_pipeline(store, ours, cell_chunk=16, device="cpu", **out)
    jrep = jax_pipeline(store, theirs, cell_chunk=16, **out)
    assert sorted(ours) == sorted(theirs)
    meta = [k for k in ours if k.rsplit("/", 1)[-1] in ("zarr.json", ".zarray", ".zgroup", ".zattrs")
            or k.startswith("time")]
    assert len(meta) >= 3 and all(ours[k] == theirs[k] for k in meta)
    assert (rep.n_cells, rep.n_valid, rep.n_chunks) == (jrep.n_cells, jrep.n_valid, jrep.n_chunks)
    got = ZarrGridSource(ours, "corrected").read_cells(0, 48)
    want = JSource(theirs, "corrected").read_cells(0, 48)
    _within(got, want, BCSD_LIMITS)
    npt.assert_allclose(rep.checksum, jrep.checksum, rtol=1e-6)


def test_pad_to_leaves_the_output_unchanged(rng):
    store, plain, padded = {}, {}, {}
    _monthly_store(rng, store)
    run_pointwise_pipeline(store, plain, cell_chunk=16, device="cpu")
    rep = run_pointwise_pipeline(store, padded, cell_chunk=16, device="cpu", pad_to=6)
    assert rep.n_valid == 44
    assert sorted(plain) == sorted(padded) and all(plain[k] == padded[k] for k in plain)


def test_a_daily_model_runs_through_the_pipeline(rng):
    """``QuantileMappingReressor`` over a daily store: the port's runner
    bitwise, the JAX pipeline within the quantile family's limits."""
    T, ny, nx = 730, 3, 4
    idx = pd.date_range("1990-01-01", periods=T, freq="D")
    s = 10 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25)[:, None, None]
    g = (284.5 + s + rng.normal(0, 2, (T, ny, nx))).astype(np.float32)
    o = (282.0 + s + rng.normal(0, 1.8, (T, ny, nx))).astype(np.float32)
    g[:, 0, 1] = o[:, 0, 1] = np.nan
    store = {}
    PZ.save_group(store, {"gcm": g, "obs": o}, chunks=(T, 1, nx), compressor="zlib", zarr_format=3)
    PZ.save_array(store, np.asarray(idx, dtype="datetime64[ns]").view(np.int64), prefix="time",
                  zarr_format=3, attrs={"kind": "datetime64[ns]"})
    make = lambda m: m.QuantileMappingReressor(extrapolate="both")  # noqa: E731
    ours, theirs = {}, {}
    run_pointwise_pipeline(store, ours, make(P), cell_chunk=8, device="cpu")
    import skdownscale_tpu as J

    jax_pipeline(store, theirs, make(J), cell_chunk=8)
    got = ZarrGridSource(ours, "corrected").read_cells(0, ny * nx, dtype=np.float32)
    want = P.PointWiseDownscaler(make(P), device="cpu").fit(_grid(g, idx), _grid(o, idx))
    want = want.predict(_grid(g, idx)).values.reshape(T, -1).T
    npt.assert_array_equal(got, want)
    _within(got, JSource(theirs, "corrected").read_cells(0, ny * nx), QUANTILE_LIMITS)


def test_pipeline_refuses_what_the_jax_pipeline_refuses(rng, monkeypatch):
    store = {}
    _monthly_store(rng, store)
    with pytest.raises(ValueError, match="no batched registry entry"):
        run_pointwise_pipeline(store, {}, model=object(), device="cpu")
    bad = dict(store)
    PZ.save_array(bad, np.zeros((12, 6, 8), np.float32), prefix="obs", zarr_format=3)
    with pytest.raises(ValueError, match="do not align"):
        run_pointwise_pipeline(bad, {}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pointwise_pipeline(store, {})
