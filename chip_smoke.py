#!/usr/bin/env python3
"""Smoke run of the PyTorch port (skdownscale_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and imports nothing of JAX.  In order, and stopping
with a non-zero exit at the first failure, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``skdownscale_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. holds the segment count-sort (K1) and segment rank-map (K2) kernels
   bitwise against their plain PyTorch versions on the card, at the main
   path's shape (131,072 rows of 12 segments of 40) and at L = 7, 31, 256
   with one segment per row, on seeded inputs with NaN, -NaN, +-0, +-inf and
   heavy ties, and times both with CUDA events;
4. holds the sliding sorted window (K5) bitwise against its plain version
   at config 5's shape (32,768 cells x 7,305 days, 31 windows), on a
   10-year ``noleap`` record and on a 3-year record whose entering buckets
   land inside value gaps, with the same adversarial values plus all-NaN
   cells, and times both;
5. config 2: fits and predicts ``PointWiseDownscaler(BcsdTemperature(
   return_anoms=False), device="cuda")`` on a 131,072-cell x 480-month
   float32 grid with about 5% NaN cells (the dense monthly path), checks
   that K1 and K2 were launched by that run, that NaN cells stay NaN, and
   that 2,048 cells agree with the port's CPU float64 path, and times it and
   its stages;
6. config 5: the same for ``BcsdTemperature(time_grouper="daily_nasa-nex",
   return_anoms=False)`` on 32,768 cells x 7,305 days (the daily streaming
   path): K5 and K2 launched, 366 climatology rows, 512 cells against the
   CPU float64 path, wall, cells/s, peak device memory and stages;
7. runs ``bcsd_fit_lazy`` + ``bcsd_predict_streaming(group_chunk=3)`` on
   config 2's valid cells on the card (the monthly streaming path), checks
   that K1 and K2 were launched once per chunk and that the result agrees
   with the dense path's.

The line before the last is a JSON object with each kernel's launches, error
and times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
# config 2: monthly BCSD, 40 years
N_CELLS, N_LAT, N_LON, N_TIME = 131_072, 256, 512, 480
# config 5: daily BCSD, 20 years from 1990-01-01 (bench.py:233)
D_CELLS, D_LAT, D_LON, D_TIME = 32_768, 128, 256, 20 * 365 + 5
NAN_CELL_SHARE = 0.05
N_REF_CELLS = 2_048
D_REF_CELLS = 512
# float32 against the float64 path, in kelvin.  Rounding at ~290 K is
# ~3e-5 K, so the bulk (99.9th percentile) must agree within 1e-3 K.  A
# float32 near-tie can swap two ranks and move that query by one step of its
# fitted CDF: at most 0.1% of values may exceed 1e-3 K, none by more than
# 5 K (CDF steps are a fraction of the ~2 K spread of a month group).
TOL_P999, TOL_SHARE, TOL_MAX = 1e-3, 1e-3, 5.0
# (rows, segments per row, segment length): the main path's, then G=1 forms
KERNEL_SHAPES = [(N_CELLS, 12, 40), (65_536, 1, 7), (65_536, 1, 31), (16_384, 1, 256)]

KERNELS = {
    "count_sort_segments": {
        "route": "cuda",
        "source": "skdownscale_tpu_torch/csrc/rank_map.cu",
        "replaces": "skdownscale_tpu/ops/pallas/rank_map_kernel.py:326",
    },
    "rank_map_segments": {
        "route": "cuda",
        "source": "skdownscale_tpu_torch/csrc/rank_map.cu",
        "replaces": "skdownscale_tpu/ops/pallas/rank_map_kernel.py:196",
    },
    "slide_sorted_windows": {
        "route": "cuda",
        "source": "skdownscale_tpu_torch/csrc/slide_sort.cu",
        "replaces": "skdownscale_tpu/ops/pallas/slide_sort_kernel.py:238",
    },
}


class SmokeFailure(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip().splitlines()
    _check(out, "nvidia-smi printed no card")
    return out[0]


def adversarial(rng, rows, L):
    """Seeded float32 (rows, L) with NaN, -NaN, +-0, +-inf and tied rows."""
    x = rng.normal(0.0, 50.0, (rows, L)).astype(np.float32)
    flat = x.reshape(-1)
    n = flat.size
    for value, share in ((np.nan, 0.002), (-np.nan, 0.001), (np.inf, 0.002), (-np.inf, 0.002),
                         (0.0, 0.002), (-0.0, 0.002)):
        flat[rng.integers(0, n, max(1, int(n * share)))] = value
    tied = rng.random(rows) < 0.25
    x[tied] = np.round(x[tied] / 25.0) * 25.0  # heavy ties (and -0 from rounding)
    x[rng.random(rows) < 0.01] = 7.0  # all-equal rows
    return x


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bitwise_err(a, b, what):
    """Max |a - b|; fails unless a and b are bitwise equal."""
    import torch

    same = torch.equal(a.view(torch.int32), b.view(torch.int32))
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    both = ~nan_a & ~nan_b
    a, b = a[both].double(), b[both].double()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())  # inf == inf: no inf - inf
    err = float(d.max()) if d.numel() else 0.0
    _check(same, f"{what}: kernel and plain version differ (max |diff| {err}, "
                 f"NaN positions equal: {bool(torch.equal(nan_a, nan_b))})")
    return err


def kernel_phase(rng, dev):
    import torch

    from skdownscale_tpu_torch.kernels import rank_map as K

    results = {}
    for B, G, L in KERNEL_SHAPES:
        x = torch.from_numpy(adversarial(rng, B * G, L).reshape(B, G * L)).to(dev)
        res = torch.from_numpy(
            np.sort(rng.normal(0.0, 1.0, (B * G, L)).astype(np.float32), axis=1).reshape(B, G * L)
        ).to(dev)
        k1 = K.count_sort_segments(x, L)
        k2 = K.rank_map_segments(x, res, L)
        torch.cuda.synchronize()
        e1 = bitwise_err(k1, K.count_sort_segments_plain(x, L), f"K1 B={B} G={G} L={L}")
        e2 = bitwise_err(k2, K.rank_map_segments_plain(x, res, L), f"K2 B={B} G={G} L={L}")
        t = {
            "count_sort_segments": (cuda_ms(lambda: K.count_sort_segments(x, L)),
                                    cuda_ms(lambda: K.count_sort_segments_plain(x, L))),
            "rank_map_segments": (cuda_ms(lambda: K.rank_map_segments(x, res, L)),
                                  cuda_ms(lambda: K.rank_map_segments_plain(x, res, L))),
        }
        for name, err in (("count_sort_segments", e1), ("rank_map_segments", e2)):
            ms, plain_ms = t[name]
            print(f"kernel {name} B={B} G={G} L={L}: bitwise equal to plain, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if (G, L) == (12, 40):  # the main path's shape goes in the JSON line
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del x, res, k1, k2
    return results


def daily_index():
    import pandas as pd

    return pd.date_range("1990-01-01", periods=D_TIME, freq="D")


def slide_kernel_phase(rng, dev):
    """K5 bitwise against its plain version at three shapes, and timed."""
    import pandas as pd
    import torch

    from skdownscale_tpu_torch.kernels import slide_sort as S
    from skdownscale_tpu_torch.models.batched import GROUP_CHUNK
    from skdownscale_tpu_torch.models.slide import build_slide_plan
    from skdownscale_tpu_torch.utils.timeindex import TimeIndex, padded_doy_groups

    cases = [
        ("config 5", D_CELLS, TimeIndex.from_pandas(daily_index()), False),
        ("noleap 10 y", 16_384, TimeIndex.range_daily(3650, start_year=1990, calendar="noleap"), False),
        ("clustered 3 y", 16_384,
         TimeIndex.from_pandas(pd.date_range("2000-01-01", periods=3 * 365 + 1, freq="D")), True),
    ]
    results = {}
    for name, C, ti, clustered in cases:
        plan = build_slide_plan(padded_doy_groups(ti), np.arange(31))
        _check(plan is not None, f"K5 {name}: no slide plan")
        T = len(ti)
        y = adversarial(rng, C, T)
        y[rng.random(C) < 0.01] = np.nan  # all-NaN cells (H5)
        if clustered:  # entering buckets land inside a value gap (H3)
            doy = ti.dayofyear
            half = C // 2
            band = np.where(doy % 2 == 0, -100.0, 100.0).astype(np.float32)
            y[:half] = band + rng.normal(0, 0.1, (half, T)).astype(np.float32)
            late = doy >= 17
            y[:half, late] = rng.normal(0, 0.5, (half, int(late.sum()))).astype(np.float32)
        yd = torch.from_numpy(y).to(dev)
        del y
        gc = GROUP_CHUNK["daily"]  # rows padded to the daily chunk grid, as the main path
        n_rows = -(-len(plan.consulted) // gc) * gc
        got = S.slide_sorted_windows(yd, plan, n_rows=n_rows)
        torch.cuda.synchronize()
        err = bitwise_err(got, S.slide_sorted_windows_plain(yd, plan, n_rows=n_rows), f"K5 {name}")
        iters = 5 if C * T > 10**8 else 20
        ms = cuda_ms(lambda: S.slide_sorted_windows(yd, plan, n_rows=n_rows), iters=iters, warmup=1)
        plain_ms = cuda_ms(lambda: S.slide_sorted_windows_plain(yd, plan, n_rows=n_rows),
                           iters=iters, warmup=1)
        out_gb = got.numel() * 4 / 1e9
        print(f"kernel slide_sorted_windows {name} ({C} cells x {T} days, {len(plan.consulted)} "
              f"windows, Lt={plan.Lt}, Wp={len(plan.w0_idx)}, BW={plan.add_idx.shape[1]}, "
              f"n_rows={n_rows}): bitwise equal to plain, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"output {out_gb:.3f} GB ({out_gb / ms:.3f} TB/s written)")
        if name == "config 5":  # the main path's shape goes in the JSON line
            results["slide_sorted_windows"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del yd, got
    return results


def make_grid(rng, index, seasonal, n_lat, n_lon):
    """A (time, lat, lon) float32 grid like bench.py (x = 283 + 1.5 +
    season + N(0, 2), y = 282 + season + N(0, 1.8)) with about 5% NaN
    cells."""
    from skdownscale_tpu_torch.xlite import DataArray

    T, C = len(index), n_lat * n_lon
    x = rng.standard_normal((T, C), dtype=np.float32)
    x *= 2.0
    x += (283.0 + 1.5 + seasonal)[:, None]
    y = rng.standard_normal((T, C), dtype=np.float32)
    y *= 1.8
    y += (282.0 + seasonal)[:, None]
    nan_cells = rng.random(C) < NAN_CELL_SHARE
    x[:, nan_cells] = np.nan
    y[:, nan_cells] = np.nan
    dims = ("time", "lat", "lon")
    coords = {"time": index, "lat": np.arange(n_lat), "lon": np.arange(n_lon)}
    shape = (T, n_lat, n_lon)
    return (DataArray(x.reshape(shape), dims, coords), DataArray(y.reshape(shape), dims, coords),
            nan_cells)


def monthly_grid(rng):
    """ROADMAP config 2: 131,072 cells x 480 months."""
    import pandas as pd

    index = pd.date_range("1970-01-01", periods=N_TIME, freq="MS")
    seasonal = (8.0 * np.sin(2 * np.pi * (index.month.to_numpy() - 1) / 12)).astype(np.float32)
    return make_grid(rng, index, seasonal, N_LAT, N_LON)


def daily_grid(rng):
    """ROADMAP config 5: 32,768 cells x 7,305 days, data as bench.py:233-248."""
    index = daily_index()
    seasonal = (10.0 * np.sin(2 * np.pi * (index.dayofyear.to_numpy() - 1) / 365.25)).astype(
        np.float32
    )
    return make_grid(rng, index, seasonal, D_LAT, D_LON)


def run_grid(label, make_model, X, Y, nan_cells, n_ref, climo_rows, card, dev, rng, kernels_used):
    """Warm-up and one timed fit+predict of a grid through
    ``PointWiseDownscaler`` on the card; checks launches, NaN cells, the
    climatology's ``climo_rows`` rows and ``n_ref`` cells against the CPU
    float64 path; prints wall, cells/s, peak memory and the stages.  Returns
    the launches."""
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.xlite import DataArray

    T = X.values.shape[0]
    C = nan_cells.size

    def fit_predict():
        m = sdt.PointWiseDownscaler(make_model(), device=dev)
        return m, m.fit(X, Y).predict(X)

    fit_predict()  # warm-up: CUDA context, cuBLAS, cached group tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    model, out = fit_predict()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in kernels_used:
        _check(launches.get(name, 0) > 0, f"{label}: the path did not launch {name}: {launches}")

    got = np.asarray(out.values).reshape(T, C)
    _check(np.isnan(got[:, nan_cells]).all(), f"{label}: a NaN cell came out with values")
    _check(np.isfinite(got[:, ~nan_cells]).all(), f"{label}: a valid cell came out with NaN or inf")
    climo = np.asarray(model.get_attr("y_climo_").values)
    _check(climo.shape == (climo_rows, *X.values.shape[1:]), f"{label}: y_climo_ shape {climo.shape}")
    climo = climo.reshape(climo_rows, C)
    _check(np.isfinite(climo[:, ~nan_cells]).all(), f"{label}: y_climo_ not finite on valid cells")
    del model, out

    # the same cells through the port's CPU float64 path
    ids = np.sort(rng.choice(np.nonzero(~nan_cells)[0], n_ref, replace=False))
    coords = {"time": X.coords["time"], "cell": np.arange(n_ref)}
    xs = X.values.reshape(T, C)[:, ids].astype(np.float64)
    ys = Y.values.reshape(T, C)[:, ids].astype(np.float64)
    ref_model = sdt.PointWiseDownscaler(make_model(), device="cpu")
    ref = ref_model.fit(DataArray(xs, ("time", "cell"), coords),
                        DataArray(ys, ("time", "cell"), coords))
    ref = ref.predict(DataArray(xs, ("time", "cell"), coords)).values
    d = np.abs(got[:, ids].astype(np.float64) - ref).ravel()
    p999, dmax, share = float(np.quantile(d, 0.999)), float(d.max()), float(np.mean(d > TOL_P999))
    print(f"{label}: {n_ref} cells vs CPU float64: max |diff| {dmax:.6g} K, "
          f"p99.9 {p999:.6g} K, share above {TOL_P999:g} K {share:.6g} "
          f"(limits p99.9 <= {TOL_P999:g}, share <= {TOL_SHARE:g}, max <= {TOL_MAX:g})")
    _check(p999 <= TOL_P999 and share <= TOL_SHARE and dmax <= TOL_MAX,
           f"{label}: the GPU output is outside the stated tolerance of the CPU float64 path")

    print(f"{label}: PointWiseDownscaler fit+predict {C} cells x {T} steps: wall {wall:.4f} s, "
          f"{C / wall:.1f} cells/s (host pack, copies and unpack included); y_climo_ "
          f"{climo_rows} rows; peak device memory {peak / 2**30:.3f} GiB; launches {launches}; "
          f"card {card}")
    stages = stage_times(X, Y, dev, make_model)
    print(f"{label}: stages of one fit+predict (ms, host clock, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f"; card {card}")
    return launches


def streaming_phase(X, Y, nan_cells, card, dev):
    """config 2's valid cells through the monthly streaming path on the
    card, against the dense path."""
    import torch

    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.models import bcsd as B
    from skdownscale_tpu_torch.models.batched import GROUP_CHUNK

    gc = GROUP_CHUNK["monthly"]
    index = X.coords["time"]
    valid = ~nan_cells
    x = torch.from_numpy(np.ascontiguousarray(X.values.reshape(N_TIME, -1)[:, valid].T)).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(Y.values.reshape(N_TIME, -1)[:, valid].T)).to(dev)
    m = B.BcsdTemperature(return_anoms=False)
    fg = m._fit_groups(index)
    plan = m._predict_plan(fg, index)
    dense = B.bcsd_predict(B.bcsd_fit(x, y, fg), x, plan, return_anoms=False)

    def stream():
        state = B.bcsd_fit_lazy(x, y, fg)
        return B.bcsd_predict_streaming(state, x, plan, return_anoms=False, group_chunk=gc)

    stream()  # warm-up: cached chunk tables
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = stream()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    n_chunks = -(-plan.transform.n_groups // gc)
    for name in ("count_sort_segments", "rank_map_segments"):
        _check(launches.get(name, 0) == n_chunks,
               f"streaming: {name} launched {launches.get(name, 0)} times, not once per chunk "
               f"({n_chunks})")
    _check(bool(torch.isfinite(out).all()), "streaming: a valid cell came out with NaN or inf")
    d = (out.double() - dense.double()).abs().flatten().cpu().numpy()
    p999, dmax, share = float(np.quantile(d, 0.999)), float(d.max()), float(np.mean(d > TOL_P999))
    device_ms = cuda_ms(stream, iters=5, warmup=1)
    print(f"streaming: bcsd_fit_lazy + bcsd_predict_streaming(group_chunk={gc}) on {x.shape[0]} "
          f"cells x {N_TIME} months vs the dense path: max |diff| {dmax:.6g} K, p99.9 {p999:.6g} K, "
          f"share above {TOL_P999:g} K {share:.6g}; wall {wall * 1e3:.3f} ms, device "
          f"{device_ms:.3f} ms (CUDA events); launches {launches}; card {card}")
    _check(p999 <= TOL_P999 and share <= TOL_SHARE and dmax <= TOL_MAX,
           "streaming: the streaming output is outside the stated tolerance of the dense path")


def stage_times(X, Y, dev, make_model):
    """The runner's steps one by one (X is packed once here; the runner
    packs it again for predict): host packing, copies, the host planning of
    group tables, the fit and predict stages and the unpack; then the device
    time of the fit and predict cores by CUDA events (planning done once,
    outside the events) and the predict core's largest kernels by
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.models import batched
    from skdownscale_tpu_torch.models import bcsd as B
    from skdownscale_tpu_torch.utils import native

    m = sdt.PointWiseDownscaler(make_model(), device=dev)
    est = m._model
    t = {}

    def lap(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        t[name] = t.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return r

    px = lap("pack grid", lambda: m._pack(m._to_feature_x(X)))
    py = lap("pack grid", lambda: m._pack(m._to_feature_x(Y)))
    ids = lap("cell mask", lambda: np.nonzero(native.valid_mask(px["flat"][0, 0]))[0].astype(np.int32))
    hx = lap("compact cells", lambda: native.pack_compact(px["flat"], ids))
    hy = lap("compact cells", lambda: native.pack_compact(py["flat"], ids))
    xd = lap("host to device", lambda: torch.from_numpy(hx).to(dev))
    yd = lap("host to device", lambda: torch.from_numpy(hy).to(dev))[:, :, 0]
    idx = px["index"]
    fg = lap("plan (host)", lambda: est._fit_groups(idx))
    plan = lap("plan (host)", lambda: est._predict_plan(fg, idx))
    state = lap("fit", lambda: batched.batched_fit(est, idx, xd, yd))
    out = lap("predict", lambda: batched.batched_predict(est, state, idx, xd, idx))
    host = lap("device to host", lambda: out.cpu().numpy())
    lap("scatter cells", lambda: native.unpack_scatter(host.reshape(len(ids), -1, 1), ids, px["n_cells"]))

    # the cores the registry runs (models/batched.py), on the tables above
    x2 = xd[..., 0]
    p = est._qm_params()
    kw = dict(variable="temperature" if est._with_x_climo else "precipitation",
              return_anoms=bool(est.return_anoms),
              **{k: p[k] for k in ("alpha", "beta", "extrapolate", "n_endpoints", "detrend")})
    if isinstance(state, B.BcsdLazyState):
        gc = batched.GROUP_CHUNK[est._timestep_kind]

        def fit_core():
            return B.bcsd_fit_lazy(x2, yd, fg, with_x_climo=est._with_x_climo)

        def predict_core():
            return B.bcsd_predict_streaming(state, x2, plan, group_chunk=gc, **kw)
    else:
        def fit_core():
            return B.bcsd_fit(x2, yd, fg, with_x_climo=est._with_x_climo, alpha=p["alpha"],
                              beta=p["beta"], detrend=p["detrend"])

        def predict_core():
            return B.bcsd_predict(state, x2, plan, **kw)

    t["fit device"] = cuda_ms(fit_core, iters=5, warmup=1)
    t["predict device"] = cuda_ms(predict_core, iters=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predict_core()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):  # kernels and copies, not the host ops above them
            rows.append((getattr(e, "device_time_total", 0.0), e.count, e.key))
    rows.sort(reverse=True)
    print("stages: predict core's largest kernels (torch.profiler, ms over calls): "
          + "; ".join(f"{k[:60]} x{n} {us / 1e3:.3f}" for us, n, k in rows[:10])
          + f"; all {sum(r[0] for r in rows) / 1e3:.3f}")
    return t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False; this run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    try:
        from skdownscale_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    try:
        card = card_line()
        print(card)  # nvidia-smi's own line: name, power limit
        t0 = time.perf_counter()
        for name, res in build.build_all().items():
            print(f"build: {res.path} in {res.seconds:.2f} s")
            for line in res.log.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"build: {line.strip()}")
        print(f"build: every source in {time.perf_counter() - t0:.2f} s")
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(SEED)
        kernels = kernel_phase(rng, dev)
        kernels.update(slide_kernel_phase(rng, dev))

        import skdownscale_tpu_torch as sdt

        X, Y, nan_cells = monthly_grid(rng)
        print(f"config 2: grid {N_TIME} months x {N_CELLS} cells float32, "
              f"{int(nan_cells.sum())} NaN cells")
        launches = run_grid("config 2", lambda: sdt.BcsdTemperature(return_anoms=False),
                            X, Y, nan_cells, N_REF_CELLS, 12, card, dev, rng,
                            ("count_sort_segments", "rank_map_segments"))
        streaming_phase(X, Y, nan_cells, card, dev)
        del X, Y

        X, Y, nan_cells = daily_grid(rng)
        print(f"config 5: grid {D_TIME} days x {D_CELLS} cells float32, "
              f"{int(nan_cells.sum())} NaN cells")
        daily = run_grid(
            "config 5",
            lambda: sdt.BcsdTemperature(time_grouper="daily_nasa-nex", return_anoms=False),
            X, Y, nan_cells, D_REF_CELLS, 366, card, dev, rng,
            ("slide_sorted_windows", "rank_map_segments"),
        )
        launches["slide_sorted_windows"] = daily["slide_sorted_windows"]
    except (SmokeFailure, subprocess.SubprocessError, OSError, RuntimeError) as e:
        print(f"chip_smoke: FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {"name": name, **KERNELS[name], "launches": launches[name], **kernels[name]}
        for name in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
