#!/usr/bin/env python3
"""Smoke run of the PyTorch port (skdownscale_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and imports nothing of JAX.  In order, and stopping
with a non-zero exit at the first failure, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``skdownscale_tpu_torch/csrc``;
3. holds the segment count-sort (K1) and segment rank-map (K2) kernels
   bitwise against their plain PyTorch versions on the card, at the main
   path's shape (131,072 rows of 12 segments of 40) and at L = 7, 31, 256
   with one segment per row, on seeded inputs with NaN, -NaN, +-0, +-inf and
   heavy ties, and times both with CUDA events;
4. fits and predicts ``PointWiseDownscaler(BcsdTemperature(return_anoms=
   False), device="cuda")`` on a 131,072-cell x 480-month float32 grid with
   about 5% NaN cells, checks that both kernels were launched by that run,
   that NaN cells stay NaN, and that 2,048 cells agree with the port's CPU
   float64 path, and times it.

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
N_CELLS, N_LAT, N_LON, N_TIME = 131_072, 256, 512, 480
NAN_CELL_SHARE = 0.05
N_REF_CELLS = 2_048
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


def make_grid(rng):
    """ROADMAP config 2: 131,072 cells x 480 months, data like bench.py."""
    import pandas as pd

    from skdownscale_tpu_torch.xlite import DataArray

    index = pd.date_range("1970-01-01", periods=N_TIME, freq="MS")
    seasonal = (8.0 * np.sin(2 * np.pi * (index.month.to_numpy() - 1) / 12)).astype(np.float32)
    x = rng.standard_normal((N_TIME, N_CELLS), dtype=np.float32)
    x *= 2.0
    x += (283.0 + 1.5 + seasonal)[:, None]
    y = rng.standard_normal((N_TIME, N_CELLS), dtype=np.float32)
    y *= 1.8
    y += (282.0 + seasonal)[:, None]
    nan_cells = rng.random(N_CELLS) < NAN_CELL_SHARE
    x[:, nan_cells] = np.nan
    y[:, nan_cells] = np.nan
    dims = ("time", "lat", "lon")
    coords = {"time": index, "lat": np.arange(N_LAT), "lon": np.arange(N_LON)}
    shape = (N_TIME, N_LAT, N_LON)
    return (DataArray(x.reshape(shape), dims, coords), DataArray(y.reshape(shape), dims, coords),
            nan_cells)


def slice_phase(rng, card, dev):
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import rank_map as K
    from skdownscale_tpu_torch.xlite import DataArray

    t0 = time.perf_counter()
    X, Y, nan_cells = make_grid(rng)
    print(f"slice: grid {N_TIME} months x {N_CELLS} cells float32, "
          f"{int(nan_cells.sum())} NaN cells, made in {time.perf_counter() - t0:.2f} s")

    def fit_predict():
        m = sdt.PointWiseDownscaler(sdt.BcsdTemperature(return_anoms=False), device=dev)
        return m, m.fit(X, Y).predict(X)

    fit_predict()  # warm-up: CUDA context, cuBLAS, cached group tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.clear()
    t0 = time.perf_counter()
    model, out = fit_predict()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in KERNELS:
        _check(launches.get(name, 0) > 0, f"the main path did not launch {name}: {launches}")

    got = np.asarray(out.values).reshape(N_TIME, N_CELLS)
    _check(got.shape == (N_TIME, N_CELLS), f"output shape {got.shape}")
    _check(np.isnan(got[:, nan_cells]).all(), "a NaN cell came out with values")
    _check(np.isfinite(got[:, ~nan_cells]).all(), "a valid cell came out with NaN or inf")
    climo = np.asarray(model.get_attr("y_climo_").values).reshape(12, N_CELLS)
    _check(np.isfinite(climo[:, ~nan_cells]).all(), "y_climo_ not finite on valid cells")

    # the same cells through the port's CPU float64 path
    ids = np.sort(rng.choice(np.nonzero(~nan_cells)[0], N_REF_CELLS, replace=False))
    coords = {"time": X.coords["time"], "cell": np.arange(N_REF_CELLS)}
    xs = X.values.reshape(N_TIME, N_CELLS)[:, ids].astype(np.float64)
    ys = Y.values.reshape(N_TIME, N_CELLS)[:, ids].astype(np.float64)
    ref_model = sdt.PointWiseDownscaler(sdt.BcsdTemperature(return_anoms=False), device="cpu")
    ref = ref_model.fit(DataArray(xs, ("time", "cell"), coords),
                        DataArray(ys, ("time", "cell"), coords))
    ref = ref.predict(DataArray(xs, ("time", "cell"), coords)).values
    d = np.abs(got[:, ids].astype(np.float64) - ref).ravel()
    p999, dmax, share = float(np.quantile(d, 0.999)), float(d.max()), float(np.mean(d > TOL_P999))
    print(f"slice: {N_REF_CELLS} cells vs CPU float64: max |diff| {dmax:.6g} K, "
          f"p99.9 {p999:.6g} K, share above {TOL_P999:g} K {share:.6g} "
          f"(limits p99.9 <= {TOL_P999:g}, share <= {TOL_SHARE:g}, max <= {TOL_MAX:g})")
    _check(p999 <= TOL_P999 and share <= TOL_SHARE and dmax <= TOL_MAX,
           "the GPU output is outside the stated tolerance of the CPU float64 path")

    print(f"slice: PointWiseDownscaler(BcsdTemperature) fit+predict {N_CELLS} cells x {N_TIME} "
          f"months: wall {wall:.4f} s, {N_CELLS / wall:.1f} cells/s (host pack, copies and "
          f"unpack included); peak device memory {peak / 2**30:.3f} GiB; "
          f"launches {launches}; card {card}")
    stages = stage_times(X, Y, dev)
    print("slice: stages of one fit+predict (ms, host clock, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f"; card {card}")
    return launches


def stage_times(X, Y, dev):
    """The runner's steps one by one (X is packed once here; the runner
    packs it again for predict): host packing, copies, the fit and predict
    stages (their device time by CUDA events as well) and the unpack."""
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.models import batched
    from skdownscale_tpu_torch.utils import native

    m = sdt.PointWiseDownscaler(sdt.BcsdTemperature(return_anoms=False), device=dev)
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
    state = lap("fit", lambda: batched.batched_fit(est, idx, xd, yd))
    out = lap("predict", lambda: batched.batched_predict(est, state, idx, xd, idx))
    host = lap("device to host", lambda: out.cpu().numpy())
    lap("scatter cells", lambda: native.unpack_scatter(host.reshape(len(ids), -1, 1), ids, px["n_cells"]))
    t["fit device"] = cuda_ms(lambda: batched.batched_fit(est, idx, xd, yd), iters=5, warmup=1)
    t["predict device"] = cuda_ms(
        lambda: batched.batched_predict(est, state, idx, xd, idx), iters=5, warmup=1
    )
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
        res = build.build("rank_map")
        print(f"build: {res.path} in {res.seconds:.2f} s")
        for line in res.log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"build: {line.strip()}")
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(SEED)
        kernels = kernel_phase(rng, dev)
        launches = slice_phase(rng, card, dev)
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
