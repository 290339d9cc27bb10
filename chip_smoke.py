#!/usr/bin/env python3
"""Smoke run of the PyTorch port (skdownscale_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and imports nothing of JAX.  In order, and stopping
with a non-zero exit at the first failure, it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``skdownscale_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together, and prints each kernel's
   registers, shared memory and spills from ``-Xptxas -v``;
3. holds the segment count-sort (K1) and segment rank-map (K2) kernels
   bitwise against their plain PyTorch versions on the card, at the main
   path's shape (131,072 rows of 12 segments of 40), at L = 7, 31, 256
   with one segment per row, at config 5's K2 shape (its streaming
   predict's chunk: valid cells x 8 groups x Lq 240), at each route edge of
   ``csrc/rank_map.cu`` (L = 64 / 65, 256 / 257, 1,024 / 1,025, 16,384 /
   16,385) and
   at L = 55,152 (one daily series of 1950-2100 a row, K2's search route),
   on seeded inputs with NaN, -NaN, +-0, +-inf and heavy ties, times both
   with CUDA events (not at the edges) beside ``torch.sort`` of the same
   rows, and prints each route's launch shape (threads a block, keys a
   lane, shared bytes, resident blocks an SM, registers and spills);
4. holds the sliding sorted window (K5) bitwise against its plain version
   at config 5's shape (32,768 cells x 7,305 days, 31 windows), on a
   10-year ``noleap`` record and on a 3-year record whose entering buckets
   land inside value gaps, with the same adversarial values plus all-NaN
   cells, and times both, with each launch's shape (a warp or a block a
   cell, threads and shared bytes a block, resident blocks an SM);
5. config 2: fits and predicts ``PointWiseDownscaler(BcsdTemperature(
   return_anoms=False), device="cuda")`` on a 131,072-cell x 480-month
   float32 grid with about 5% NaN cells (the dense monthly path), checks
   that K1 and K2 were launched by that run, that NaN cells stay NaN, and
   that 2,048 cells agree with the port's CPU float64 path, and times it and
   its stages;
6. config 5: the same for ``BcsdTemperature(time_grouper="daily_nasa-nex",
   return_anoms=False)`` on 32,768 cells x 7,305 days (the daily streaming
   path): K5 and K2 launched, 366 climatology rows, 512 cells against the
   CPU float64 path, wall, cells/s, peak device memory and stages; then
   the same grid with ``qm_kwargs={"detrend": True}``, whose
   streaming predict sorts the raw 620-day windows with K9: fit+predict on
   K9's route against the route without K9 (the plain version above K1's
   256), alternating, outputs bitwise equal, walls and device times;
7. runs ``bcsd_fit_lazy`` + ``bcsd_predict_streaming(group_chunk=3)`` on
   config 2's valid cells on the card (the monthly streaming path), checks
   that K1 and K2 were launched once per chunk and that the result agrees
   with the dense path's;
8. holds the batched table interpolation (K6) bitwise against its plain
   version at config 9b's two calls (65,536 rows, 1,462 knots, 732 queries,
   one with per-cell knots and a shared plotting-position vector as values,
   the other the reverse), at a small table (42 knots, 40 queries) and at a
   20-year daily table (16,384 rows, 7,307 knots, 3,654 queries), on seeded
   inputs with ties, +inf pads, +-1e20 sentinels, NaN knot rows, knot hits
   and NaN / +-inf queries, and at config 8's fut block (6,144 rows, each
   with its own 3,650 knots and values, 3,650 queries, taken from a
   one-rotation ``mbcn_correct``), and times both, with each launch's
   shape (staged or not, threads and shared bytes a block, resident blocks
   an SM, blocks in the persistent grid);
9. config 9b, this slice's main path: fits ``PointWiseDownscaler(
   TrendAwareQuantileMappingRegressor(QuantileMappingReressor(
   extrapolate="both")))`` over 1,460 days from 1990-01-01 and predicts 730
   days from 2050-01-01 on 65,536 cells (256 x 256, about 5% NaN cells):
   K6 launched, 512 cells against the CPU float64 path, wall, cells/s, peak
   device memory and stages;
10. config 9a: ``QuantileMapper(detrend=True)`` fit + ``transform`` on the
    same data (K2 with one 730-long segment a row), with K2's time there;
    then the same estimator on 64 cells of daily data from 1950-01-01 to
    2100-12-31 (K2 at L = 55,152) against the CPU float64 path;
11. config 3: ``EquidistantCdfMatcher(kind="difference", extrapolate="both")``
    on 16,384 cells fit over 3,650 days, predicting 3,650 days (the
    equal-length identity branch) and 1,825 days (host bracket tables); no
    kernel runs there;
12. holds the fused GARD kernels against their plain versions at config 4's
    shape (2,048 cells, 3,650 training days, 365 queries, k = 200, data as
    bench.py:1059-1064): K7 for the four PureAnalog kinds with and without
    a threshold (the exceedance probability and the best / sample analog
    bitwise, the means and deviations within float32 reduction error), K8
    at f = 1, 2, 3, 5 (the count row bitwise, the sums and the Newton
    probability within float32 error), and times both, with each launch's
    warps a block and resident warps an SM;
13. config 4a and 4b, this slice's main path: fits and predicts
    ``PointWiseDownscaler(PureAnalog(n_analogs=200, kind="mean_analogs",
    thresh=13.0))`` and ``(AnalogRegression(n_analogs=200, thresh=13.0))`` on
    a two-variable daily Dataset of 2,048 cells (32 x 64, about 5% NaN
    cells), fit over 3,650 days from 1990-01-01, predict over 365 days:
    K7 / K8 launched, three outputs, NaN cells NaN, 128 cells against the
    CPU float64 path, wall, cells/s, peak device memory and stages;
14. ``PureRegression(thresh=13.0)`` on the same grid (no kernel: the
    batched linear and logistic fits);
15. holds the row sort K9's three forms (``sort_rows``,
    ``sort_rows_with_positions``, ``unsort_rows``) bitwise against their
    plain versions, values and positions both, at config 8's rows (6,144 x
    3,650), monthly MBCn rows (6,144 x 304), the dense daily BCSD fit's
    windows (512 cells x 366 windows x 620) and adversarial rows (NaN
    payloads including the bits 0x7fffffff, +-0, +-inf, heavy ties,
    all-equal rows, L = 1, 7, 37, 304, 620, 1,025, 3,650 and K9_MAX_LEN,
    with row counts that leave a block of four rows part full), and times
    each form beside its bound, its plain version and one ``torch.sort``
    call;
16. config 8, this slice's main path: ``mbcn_grid`` on three 3-variable
    daily Datasets (obs, hist, fut; 3,650 days each; data as
    bench.py:731-736) of 2,048 cells (32 x 64, about 5% NaN cells), 20
    rotations: K9 launched 22 times per form and K6 once per rotation,
    every output row a permutation of the card's own QDM margins, 128 cells
    against the CPU float64 path (margins, then the output after 1, 3, 5,
    10 and 20 rotations), two wrong paths (rotations rounded to bfloat16,
    the last rotation dropped) shown to fall outside the limits, wall,
    cells/s, peak memory and stages;
17. config 8 monthly (``group="month"``) on the same grid: K9 at
    month-length rows;
18. config 8b: 16,384 valid cells (128 x 136, 1,024 NaN cells) in
    2,048-cell chunks, one timed run of the grid runner;
19. config 7 (BASELINE config 7): ``PointWiseDownscaler(ZScoreRegressor(
    window_width=31))`` fit and predict on 65,536 cells (256 x 256, about
    5% NaN cells) x 7,305 days from 1990-01-01 (data as bench.py:452-471;
    the banded rolling form on the card): valid cells NaN exactly on the
    window's edges, 512 cells against the CPU float64 path, wall, cells/s,
    device time, peak memory;
20. config 6 (BASELINE config 6): ``PiecewiseLinearRegression(n_segments=6)``
    with ``fit_option="arrm"`` and ``"auto"`` on 16,384 cells (128 x 128) x
    1,000 steps (data as bench.py:346-351), 256 cells of each against the
    CPU float64 path ('auto' by its per-cell SSR and prediction spread);
21. the per-cell object fallback of ``PointWiseDownscaler``: 256 cells of
    config 7's data cut to 1,825 days through a least-squares regression
    with scikit-learn's API (the card's machine has no scikit-learn), then
    64 of them through a ``TrendAwareQuantileMappingRegressor`` whose trend
    transformer is a subclass (each cell fit on the card by the single-cell
    API): host loops, cells/s, every cell against the CPU float64 path;
22. config G: ``GlobalDownscaler(GlobalQuantileMapper())`` (Q = 2,048) and
    ``GlobalLinearRegressor`` in both intercept modes on 65,536 cells (256 x
    256, about 5% NaN cells) x 3,650 days: K6 launched twice by the ladder
    fit and once by ``transform``, the ladders and coefficients against the
    CPU float64 path on the whole grid and the outputs on 512 cells, and K6
    at its two new shapes (one row of 2.4e8 knots; 65,536 rows on one
    shared 2,048-knot table) bitwise against its plain version and timed.

The line before the last is a JSON object with each kernel's launches by
its path, error, times, bound and the one PyTorch call that computes the
same function (where there is one); the last line is
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --trials [source ...]`` runs only the design
trials of K5, K6 and K1 / K2 (or of the named sources: ``slide_sort``,
``interp``, ``rank_map``): each trial switch of ``csrc/slide_sort.cu``,
``csrc/interp.cu`` and ``csrc/rank_map.cu`` (``TRIALS``) is built as a
variant, held bitwise against the default build, and timed beside it in
turns at config 5 (K5), at config 8's fut block and config 9b's two calls
(K6), and at config 2's shape and config 5's K2 shape (K1, K2), config
9a's rows and 20-year daily rows (K2), with each build's launch shape,
registers and spills.
"""

from __future__ import annotations

import ctypes
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
# the quantile family (configs 9a, 9b, 3), same metric: detrending in
# float32 perturbs a series by about its float32 spacing at ~283 K (3e-5 K),
# and the piecewise-linear map moves that perturbation by the ratio of the
# local y and x knot spacings, up to one y-CDF step where two x knots nearly
# tie.  The bulk stays within 2e-3 K at the 99.9th percentile, at most 0.5%
# of values above 1e-3 K, none above 5 K.
TOL_Q = (2e-3, 5e-3, 5.0)
# (rows, segments per row, segment length): the main path's, then G=1 forms
KERNEL_SHAPES = [(N_CELLS, 12, 40), (65_536, 1, 7), (65_536, 1, 31), (16_384, 1, 256)]
# K1 and K2 at each route edge of csrc/rank_map.cu: the packed routes'
# longest L and one above (K1 64 / 65, K2 256 / 257), the warp route's
# 1,024 / 1,025 and the block route's 16,384 / 16,385 (bitwise, not timed)
EDGE_SHAPES = [(4_096, 4, 64), (4_096, 4, 65), (2_048, 2, 256), (2_048, 2, 257),
               (512, 1, 1_024), (512, 1, 1_025), (128, 1, 16_384), (128, 1, 16_385)]
# K2 with one daily series of 1950-01-01 to 2100-12-31 a row (L = 55,152,
# the search route), and the QuantileMapper grid of that length
LONG_SHAPE = (300, 1, 55_152)
LONG_CELLS, LONG_SIDE = 64, 8
# config 9 (bench.py:583-659): 65,536 cells, fit 4 y daily, predict 2 y
Q_CELLS, Q_SIDE, Q_FIT, Q_PRED = 65_536, 256, 1_460, 730
# config 3 (ROADMAP Queue 1 item 7): QDM, 16,384 cells, fit 10 y daily
E_CELLS, E_SIDE, E_FIT, E_PRED = 16_384, 128, 3_650, 1_825
# config 4 (bench.py:1050-1112): GARD, 2,048 cells, fit 10 y daily, 365
# queries, k = 200, two predictors
G_CELLS, G_LAT, G_LON, G_FIT, G_PRED, G_K, G_F = 2_048, 32, 64, 3_650, 365, 200, 2
G_REF_CELLS = 128
# GARD float32 on the card against the CPU float64 path, over the three
# outputs.  Rounding alone moves a mean of 200 analogs near 15 by ~1e-6 and
# AnalogRegression's float32 sufficient statistics and Newton steps its
# outputs by ~1e-5.  A float32 near-tie at the k-th distance can swap one
# analog for another: that moves pred by about dy/k (~0.01), the
# probability by 1/k (0.005) or, for AnalogRegression, through its Newton
# fit, and under the threshold can flip pred between 0 and ~15 and the
# error between NaN and a number.  Such swaps need two distances within
# ~1e-6 of each other at the boundary, a few queries in 10^4, so: the
# 99.9th percentile of |diff| over values finite in both <= 1e-3, at most
# 0.1% of them above 1e-3, at most 0.1% of values NaN in one and not the
# other; no bound on the maximum.
TOL_GARD = (1e-3, 1e-3, 1e-3)
# config 8 (bench.py:698-741, BASELINE config 8): MBCn with d = 3 variables,
# 10 years daily (n = m = p = 3,650), 20 rotations, 2,048 cells (32 x 64);
# config 8b: 16,384 valid cells (128 x 136 with 1,024 NaN cells) in
# 2,048-cell chunks
M_CELLS, M_LAT, M_LON, M_T, M_D, M_ROT = 2_048, 32, 64, 3_650, 3, 20
M_REF_CELLS = 128
MB_LAT, MB_LON, MB_VALID, MB_CHUNK = 128, 136, 16_384, 2_048
# launches of each K9 form in one mbcn_correct: one a rotation (the rotated
# obs sort, the hist sort with positions, the unsort of the mapped values)
# and one in each of the two closing reorders; the QDM margins sort with
# torch.sort
K9_PER_CORRECT = M_ROT + 2
# MBCn on the card (float32) against the CPU float64 path on M_REF_CELLS
# cells.  Every output row must be a permutation of the card's own QDM
# margin row, bitwise, and the margins must meet TOL_Q.  The rotation rounds
# are chaotic in float32 (the JAX package's float32 run drifts from its
# float64 run alike, tests/test_torch_mbc.py): a float32 near-tie swaps two
# ranks, which moves both values by a gap of the obs distribution, which the
# next rotation mixes into the other coordinates, where it is no longer
# small against their gaps.  The swapped share grows several times a round
# (mbcn_depth_drift in float32 on the CPU, 16 cells of config 8: 0.11% of
# ranks moved after 3 rounds, 0.75% after 5, 22% after 10, 86% after 20;
# monthly 0.013%, 0.09%, 1.1%, 3.5%).  So the element-wise limits hold
# after MBCN_SHORT_ROT rounds and the full depth is held to the statistics
# that MBCn corrects: the rank (Spearman) correlation of each (cell,
# variable) series with the float64 run's, and each cell's correlation
# matrix across the variables.  Each limit sits between the sound reading
# on the card and that of a wrong path (mbcn_controls: the rotations rounded
# to bfloat16, the last rotation dropped), near their geometric mean, as
# read in a first card call of these checks (readings in PERF.md section 2).
# Monthly (12 corrections on rows of about 304) drifts more and has limits
# of its own.  A dropped rotation is caught after 3 rounds; after 20 the
# rounds have converged and it stays inside the float32 drift, so a control
# must fail at one depth at least.
MBCN_SHORT_ROT = 3
TOL_MBCN_SHORT = (0.01, 0.004)  # share of time steps with another rank, p99.9 |diff|
# min Spearman, max |correlation difference|, by grouping
TOL_MBCN_FULL = {None: (0.99967, 0.005), "month": (0.994, 0.009)}
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): the
# bound of a kernel is the larger of its compulsory bytes over the memory
# rate and its operations over the float32 (non-tensor-core) rate
# config 7 (BASELINE config 7, bench.py:452-471): ZScoreRegressor(31) on
# 65,536 cells (256 x 256) x 7,305 days from 1990-01-01, 512 cells checked.
# Float32 rounding at ~283 K is ~3e-5 K; the fit's pooled sums and the
# rolling sums run on centred values, which adds ~1e-5 K.  The bulk must
# stay within 5e-4 K at the 99.9th percentile, none above 5e-3 K.
Z_CELLS, Z_SIDE, Z_WINDOW, Z_REF_CELLS = 65_536, 256, 31, 512
TOL_Z = (5e-4, 5e-3)  # p99.9, max |diff| in K
# config 6 (BASELINE config 6, bench.py:346-351): ARRM, n_segments = 6, on
# 16,384 cells (128 x 128) x 1,000 steps, 256 cells checked.  The ARRM fits
# run in float64 on the card as on the CPU (models/arrm.py), from the same
# float32 inputs, so 'arrm' differs only by summation order and the float32
# rounding of the output (~1e-6 at |y| <= 17): p99.9 <= 1e-5, at most 0.1%
# of values above 1e-5, none above 1.0 (a window whose r² ties another's
# to rounding may move a break by a few samples).  'auto' refines
# redundant breaks by Adam on a flat, non-convex SSR, where runs that
# differ by rounding end at other local minima (PERF.md section 2): the
# median over cells of |SSR_card / SSR_cpu - 1| <= 1%, the median per-cell
# RMS of the prediction difference <= 0.05 (a sixth of the noise's 0.3), and
# every card fit's residual RMS <= 2.0 (better than a straight line).
A_SIDE, A_TIME, A_REF_CELLS = 128, 1_000, 256
TOL_ARRM = (1e-5, 1e-3, 1.0)  # p99.9, share above the p99.9 limit, max
TOL_AUTO = (0.01, 0.05, 2.0)  # median |ratio - 1|, median RMS, worst residual RMS
# the per-cell object fallback: 256 cells of config 7's data cut to 1,825
# days (a least-squares regression with scikit-learn's API), the first 64
# through a refused TrendAware model,
# each cell on the card (float32) against the CPU float64 path: the
# quantile family's bulk and maximum (TOL_Q)
F_CELLS, F_TA_CELLS, F_TIME = 256, 64, 1_825
TOL_FALLBACK = (2e-3, 5.0)  # p99.9, max |diff| in K
# config G: the pooled models on config 9b's 65,536 cells (256 x 256) x
# 3,650 days, Q = 2,048.  The float32 ladder takes its plotting positions
# from float64 ranks rounded to float32 (a relative 6e-8, about 14 of
# 2.4e8 ranks), which moves a quantile by 14 sample gaps: ~1e-6 K in the
# bulk, up to ~1e-3 K at the sparse tails; with float32 rounding the
# ladders must agree within 1e-2 K everywhere, the mapped outputs within
# 2e-3 K at the 99.9th percentile and 1e-2 K at most.  The pooled linear
# sums run per cell and then as a tree over cells in float32: relative
# error ~1e-6, so coefficients within 1e-4 relative, intercepts and
# outputs within 1e-2 K.
G_TIME, G_Q, G_REF_CELLS_OUT = 3_650, 2_048, 512
TOL_G_LADDER = 1e-2
TOL_G = (2e-3, 1e-2)
TOL_G_LINEAR = (1e-4, 1e-2, 1e-2)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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
    "batched_interp": {
        "route": "cuda",
        "source": "skdownscale_tpu_torch/csrc/interp.cu",
        "replaces": "skdownscale_tpu/ops/pallas/interp_kernel.py:92",
    },
    "pure_analog_stats": {
        "route": "cuda",
        "source": "skdownscale_tpu_torch/csrc/knn.cu",
        "replaces": "skdownscale_tpu/ops/pallas/knn_kernel.py:269",
    },
    "analog_regression_stats": {
        "route": "cuda",
        "source": "skdownscale_tpu_torch/csrc/knn.cu",
        "replaces": "skdownscale_tpu/ops/pallas/knn_kernel.py:535",
    },
    "sort_rows": {
        "route": "cuda",
        "source": "skdownscale_tpu_torch/csrc/sort_rows.cu",
        "replaces": "skdownscale_tpu/ops/pallas/sort_kernel.py:247",
    },
    "sort_rows_with_positions": {
        "route": "cuda",
        "source": "skdownscale_tpu_torch/csrc/sort_rows.cu",
        "replaces": "skdownscale_tpu/ops/pallas/sort_kernel.py:260",
    },
    "unsort_rows": {
        "route": "cuda",
        "source": "skdownscale_tpu_torch/csrc/sort_rows.cu",
        "replaces": "skdownscale_tpu/ops/pallas/sort_kernel.py:274",
    },
}
K9_FORMS = ("sort_rows", "sort_rows_with_positions", "unsort_rows")


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


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take for
    ``n_bytes`` of compulsory traffic and ``n_ops`` float32 operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def rank_map_ptxas(kernel, geo):
    """The ``-Xptxas -v`` line of the kernel that a K1 / K2 launch of
    geometry ``geo`` runs first, as a mangled-name fragment."""
    items = geo["items"]
    return {"packed": f"packed_kernelILb{int(kernel == 'count_sort_segments')}E",
            "warp": f"{'count_sort' if kernel == 'count_sort_segments' else 'rank_map'}_warp_kernelILi{items}E",
            "block": f"rank_map_block_kernelILi{items}E",
            "search": f"sort_chunks_kernelILi{items}E"}[geo["route"]]


def describe_rank_map(kernel, L, log, lib=None):
    """K1 / K2's route and launch shape at length ``L`` (of the default
    build, or of ``lib``), with registers and spills from its build log."""
    from skdownscale_tpu_torch.kernels import rank_map as K

    geo = K.launch_geometry(kernel, L, lib)
    return (f"route {geo['route']}, {geo['threads']} threads a block, {geo['items']} "
            f"{'elements a thread' if geo['route'] == 'packed' else 'keys a lane'}, "
            f"{geo['smem_bytes']} B shared a block, {geo['blocks_per_sm']} resident blocks an SM; "
            f"{ptxas_of(log, rank_map_ptxas(kernel, geo))}")


def config5_k2_shape():
    """K2's shape in config 5's streaming predict: (valid cells, segments of
    one group chunk, Lq of the predict plan)."""
    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.models.batched import GROUP_CHUNK

    est = sdt.BcsdTemperature(time_grouper="daily_nasa-nex", return_anoms=False)
    index = daily_index()
    plan = est._predict_plan(est._fit_groups(index), index)
    return round(D_CELLS * (1 - NAN_CELL_SHARE)), GROUP_CHUNK["daily"], plan.transform.indices.shape[1]


def kernel_phase(rng, dev):
    """K1 and K2 bitwise against their plain versions at KERNEL_SHAPES,
    config 5's K2 shape, the route edges (EDGE_SHAPES) and LONG_SHAPE, with
    each route's launch shape; timed at all but the edges."""
    import torch

    from skdownscale_tpu_torch.kernels import build
    from skdownscale_tpu_torch.kernels import rank_map as K

    log = build.build("rank_map").log
    shapes = [(*s, True) for s in (*KERNEL_SHAPES, config5_k2_shape())]
    shapes += [(*s, False) for s in EDGE_SHAPES] + [(*LONG_SHAPE, True)]
    results = {}
    for B, G, L, timed in shapes:
        x = torch.from_numpy(adversarial(rng, B * G, L).reshape(B, G * L)).to(dev)
        res = torch.from_numpy(rng.normal(0.0, 1.0, (B * G, L)).astype(np.float32)).to(dev)
        res = torch.sort(res, dim=1).values.reshape(B, G * L)  # the values np.sort gives
        runs = {"rank_map_segments": (lambda: K.rank_map_segments(x, res, L),
                                      lambda: K.rank_map_segments_plain(x, res, L))}
        if L <= K.COUNT_SORT_MAX_LEN:
            runs["count_sort_segments"] = (lambda: K.count_sort_segments(x, L),
                                           lambda: K.count_sort_segments_plain(x, L))
        n = B * G * L
        # K1 reads and writes each key once, and a sort needs n log2 L
        # compares; K2 reads the queries and results and writes the output
        n_bytes = {"count_sort_segments": 8 * n, "rank_map_segments": 12 * n}
        # the one PyTorch call that sorts every segment: K1's function but
        # for its NaN and -0 order; for K2 it sorts only
        sort_ms = cuda_ms(lambda: torch.sort(x.view(-1, L), dim=-1), iters=5, warmup=1) if timed else None
        for name, (kernel, plain) in runs.items():
            _check(K.launch_geometry(name, L)["route"] == K.route(name, L),
                   f"{name} L={L}: the build's route is not kernels/rank_map.route's")
            got = kernel()
            torch.cuda.synchronize()
            err = bitwise_err(got, plain(), f"{name} B={B} G={G} L={L}")
            del got
            shape = describe_rank_map(name, L, log)
            if not timed:
                print(f"kernel {name} B={B} G={G} L={L}: bitwise equal to plain; {shape}")
                continue
            iters = 5 if L > 1_024 else 20
            ms, plain_ms = cuda_ms(kernel, iters=iters), cuda_ms(plain, iters=iters)
            b_ms, b_by = bound(n_bytes[name], n * np.log2(L) if L > 1 else n)
            one = (f"torch.sort {sort_ms:.4f} ms" if name == "count_sort_segments"
                   else f"torch.sort of the same rows {sort_ms:.4f} ms (sorts only, not the same function)")
            print(f"kernel {name} B={B} G={G} L={L}: bitwise equal to plain, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {one}; {shape}")
            if (G, L) == (12, 40):  # the main path's shape goes in the JSON line
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by,
                                 "library_ms": sort_ms if name == "count_sort_segments" else None}
        del x, res
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
        # reads each series once, writes each window slot once
        b_ms, b_by = bound(C * T * 4 + got.numel() * 4, got.numel() * np.log2(plan.Lto))
        geo = S.launch_geometry(plan)
        print(f"kernel slide_sorted_windows {name} ({C} cells x {T} days, {len(plan.consulted)} "
              f"windows, Lt={plan.Lt}, Wp={len(plan.w0_idx)}, BW={plan.add_idx.shape[1]}, "
              f"n_rows={n_rows}): bitwise equal to plain, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), output {out_gb:.3f} GB ({out_gb / ms:.3f} TB/s written); "
              f"{'a block' if geo['block_route'] else 'a warp'} a cell, {geo['threads']} threads a "
              f"block, {geo['smem_bytes']} B shared a block, {geo['blocks_per_sm']} resident blocks an "
              f"SM, {geo['items']} window-0 keys a lane")
        if name == "config 5":  # the main path's shape goes in the JSON line
            results["slide_sorted_windows"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
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


def config5_detrend_phase(X, Y, nan_cells, card, dev):
    """Config 5 with detrended quantile mapping, the BCSD path that runs
    K9: ``BcsdTemperature(time_grouper="daily_nasa-nex", return_anoms=False,
    qm_kwargs={"detrend": True})`` has no slide route, so its streaming
    predict gathers and sorts each chunk's raw 620-day fit windows (K9,
    above K1's 256).  Fit+predict through ``PointWiseDownscaler`` on the
    route the port takes (K9) and on the one it took before K9 (every window
    above 256 to the plain version: ``K9_MAX_LEN`` set to K1's limit),
    alternating K9, plain, plain, K9 after a warm-up of each; the outputs
    bitwise equal, NaN cells NaN; then the predict core's device time on
    each route by CUDA events."""
    import contextlib
    from unittest import mock

    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.kernels import sort_rows as S
    from skdownscale_tpu_torch.kernels.rank_map import COUNT_SORT_MAX_LEN
    from skdownscale_tpu_torch.models import bcsd as B
    from skdownscale_tpu_torch.models.batched import GROUP_CHUNK

    label = "config 5 detrend"
    routes = {"K9": contextlib.nullcontext,
              "plain": lambda: mock.patch.object(S, "K9_MAX_LEN", COUNT_SORT_MAX_LEN)}

    def model():
        return sdt.BcsdTemperature(time_grouper="daily_nasa-nex", return_anoms=False,
                                   qm_kwargs={"detrend": True})

    def fit_predict():
        m = sdt.PointWiseDownscaler(model(), device=dev)
        return np.asarray(m.fit(X, Y).predict(X).values)

    for route in routes:  # warm-ups
        with routes[route]():
            fit_predict()
    walls, outs, launches = {r: [] for r in routes}, {}, {}
    for route in ("K9", "plain", "plain", "K9"):
        with routes[route]():
            torch.cuda.synchronize()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            outs[route] = fit_predict()
            walls[route].append(time.perf_counter() - t0)
            launches[route] = dict(LAUNCHES)
    _check(launches["K9"].get("sort_rows", 0) > 0 and "sort_rows" not in launches["plain"],
           f"{label}: K9 launches {launches}")
    _check(np.array_equal(outs["K9"].view(np.int32), outs["plain"].view(np.int32)),
           f"{label}: the K9 route and the plain route give different outputs")
    T, C = D_TIME, nan_cells.size
    got = outs["K9"].reshape(T, C)
    _check(np.isnan(got[:, nan_cells]).all() and np.isfinite(got[:, ~nan_cells]).all(),
           f"{label}: NaN cells or valid cells came out wrong")

    # the predict core on the card, on each route
    est = model()
    index = X.coords["time"]
    fg = est._fit_groups(index)
    plan = est._predict_plan(fg, index)
    x, y = (torch.from_numpy(np.ascontiguousarray(A.values.reshape(T, -1)[:, ~nan_cells].T)).to(dev)
            for A in (X, Y))
    state = B.bcsd_fit_lazy(x, y, fg)
    p = est._qm_params()
    kw = {k: p[k] for k in ("alpha", "beta", "extrapolate", "n_endpoints", "detrend")}

    def core():
        return B.bcsd_predict_streaming(state, x, plan, return_anoms=False,
                                        group_chunk=GROUP_CHUNK["daily"], **kw)

    device = {r: [] for r in routes}
    for route in ("K9", "plain", "plain", "K9"):
        with routes[route]():
            device[route].append(cuda_ms(core, iters=2, warmup=1))
    for r in routes:
        print(f"{label}: route {r}: fit+predict {C} cells x {T} days, walls "
              + ", ".join(f"{w:.4f}" for w in walls[r]) + f" s ({C / np.mean(walls[r]):.1f} cells/s); "
              f"predict core on the card " + ", ".join(f"{d:.3f}" for d in device[r])
              + f" ms (CUDA events); launches {launches[r]}; card {card}")
    print(f"{label}: K9 route minus plain route: wall {np.mean(walls['K9']) - np.mean(walls['plain']):+.4f} s, "
          f"predict core {np.mean(device['K9']) - np.mean(device['plain']):+.3f} ms; outputs bitwise equal")


def lapper(t):
    """``lap(name, fn)``: runs ``fn`` between two synchronises and adds its
    host-clock ms to ``t[name]``."""
    import torch

    def lap(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        t[name] = t.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return r

    return lap


def print_top_kernels(what, fn):
    """One ``fn()`` under ``torch.profiler``: its ten largest device kernels
    and copies (not the host ops above them), by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            rows.append((getattr(e, "device_time_total", 0.0), e.count, e.key))
    rows.sort(reverse=True)
    print(f"stages: {what} core's largest kernels (torch.profiler, ms over calls): "
          + "; ".join(f"{k[:60]} x{n} {us / 1e3:.3f}" for us, n, k in rows[:10])
          + f"; all {sum(r[0] for r in rows) / 1e3:.3f}")


def stage_times(X, Y, dev, make_model):
    """The runner's steps one by one (X is packed once here; the runner
    packs it again for predict): host packing, copies, the host planning of
    group tables, the fit and predict stages and the unpack; then the device
    time of the fit and predict cores by CUDA events (planning done once,
    outside the events) and the predict core's largest kernels by
    ``torch.profiler``."""
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.models import batched
    from skdownscale_tpu_torch.models import bcsd as B
    from skdownscale_tpu_torch.utils import native

    m = sdt.PointWiseDownscaler(make_model(), device=dev)
    est = m._model
    t = {}
    lap = lapper(t)
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
    print_top_kernels("predict", predict_core)
    return t


def interp_tables(g, dev, B, n_fit, n_q, call):
    """Seeded float32 inputs of one K6 call of the QMR predict, made on the
    card: ``call`` 1 interpolates sorted test values (B, n_q+2) on per-cell
    sorted fit values (B, n_fit+2) with the shared plotting positions as
    values; ``call`` 2 interpolates plotting positions (B, n_q+2) on the
    shared plotting positions with per-cell values.  Sorted rows end in the
    OLS endpoints near -+3e22, the pp vector in the -+1e20 sentinels.  Made
    adversarial: tied rows, +inf-padded rows (pad_table form), a NaN knot in
    some rows, knot hits, NaN and +-inf queries."""
    import torch

    def sorted_rows(rows, n, loc):
        v = torch.randn((rows, n), generator=g, device=dev) * 2.0 + loc
        v[: rows // 10] = torch.round(v[: rows // 10] * 2.0) / 2.0  # ties
        v = torch.sort(v, dim=1).values
        lo, hi = torch.full((rows, 1), -3e22, device=dev), torch.full((rows, 1), 3e22, device=dev)
        return torch.cat([lo, v, hi], dim=1).contiguous()

    L, Q = n_fit + 2, n_q + 2
    pp = torch.cat([torch.tensor([-1e20], device=dev),
                    (torch.arange(1, n_fit + 1, device=dev, dtype=torch.float32) - 0.4) / (n_fit + 0.2),
                    torch.tensor([1e20], device=dev)])[None]
    table = sorted_rows(B, n_fit, 283.0)
    pad = torch.arange(B, device=dev) % 20 == 3  # +inf-padded rows: the last fifth
    cut = L - L // 5
    if call == 1:
        table[pad, cut:] = float("inf")
        q = sorted_rows(B, n_q, 283.6)
        knots = table
    else:
        table[pad, cut:] = table[pad, cut - 1 : cut]
        q = torch.sort(torch.rand((B, Q), generator=g, device=dev) * 1.1 - 0.05, dim=1).values
        q[:, 0], q[:, -1] = -1e20, 1e20
        q[::50, -2] = 8.7e4  # a re-extrapolated plotting position
        knots = pp.expand(B, L)
    hit = torch.rand((B, Q), generator=g, device=dev) < 0.05
    cols = torch.randint(0, L, (B, Q), generator=g, device=dev)
    q = torch.where(hit, torch.gather(knots, 1, cols), q)
    q[::97, 5] = float("nan")
    q[::89, 6] = float("inf")
    q[::83, 7] = float("-inf")
    table[1::101, L // 3] = float("nan")  # NaN knot rows
    q = q.contiguous()
    return (table, pp, q) if call == 1 else (pp, table, q)


def mbcn_interp_inputs(dev):
    """K6's inputs at config 8's fut block, taken from a one-rotation
    ``mbcn_correct`` on config 8's data (bench.py:731-736, no NaN cells):
    6,144 rows of 3,650 knots (the sorted rotated hist margins), their own
    values (the rank-mapped rotated obs) and 3,650 queries (the rotated fut
    margins); no table is shared.  The margins' K6 calls share a table and
    are not taken."""
    from unittest import mock

    from skdownscale_tpu_torch.models import mbc as PM
    from skdownscale_tpu_torch.ops import interp as OI

    dsets = mbcn_datasets(np.random.default_rng(SEED), M_LAT, M_LON, np.zeros(M_CELLS, dtype=bool))
    variables = list(dsets[0].data_vars)
    blocks = [PM.to_device(PM.pack_dataset(ds, variables)[0], dev) for ds in dsets]
    real, seen = OI.batched_interp, []

    def record(xp, fp, q):
        if xp.shape[0] == fp.shape[0] == q.shape[0] == M_CELLS * M_D:
            seen.append((xp.clone(), fp.clone(), q.clone()))
        return real(xp, fp, q)

    with mock.patch.object(OI, "batched_interp", record):
        PM.mbcn_correct(*blocks, PM.mbcn_rotations(M_D, 1, 0), kinds=("difference",) * M_D)
    _check(len(seen) == 1, f"config 8: {len(seen)} K6 calls on unshared tables in one rotation, not 1")
    return seen[0]


def interp_kernel_phase(dev):
    """K6 bitwise against its plain version at config 9b's two calls, a
    small table, a 20-year daily table and config 8's fut block (every row
    its own knots and values), and timed."""
    import torch

    from skdownscale_tpu_torch.kernels import interp as I

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [("config 9b call 1", Q_CELLS, Q_FIT, Q_PRED, 1), ("config 9b call 2", Q_CELLS, Q_FIT, Q_PRED, 2),
             ("small", Q_CELLS, 40, 38, 1), ("20-year daily", 16_384, 7_305, 3_652, 2), ("config 8 fut block",)]
    results = {}
    for name, *shape in cases:
        xp, fp, q = interp_tables(g, dev, *shape) if shape else mbcn_interp_inputs(dev)
        B = q.shape[0]
        got = I.batched_interp(xp, fp, q)
        torch.cuda.synchronize()
        err = bitwise_err(got, I.batched_interp_plain(xp, fp, q), f"K6 {name}")
        ms = cuda_ms(lambda: I.batched_interp(xp, fp, q))
        plain_ms = cuda_ms(lambda: I.batched_interp_plain(xp, fp, q), iters=5, warmup=1)
        L, Q = xp.shape[1], q.shape[1]
        n_bytes = 4 * (xp.numel() + fp.numel() + q.numel() + got.numel())
        b_ms, b_by = bound(n_bytes, B * Q * (np.ceil(np.log2(L)) + 15))
        shared = "fp" if fp.shape[0] == 1 else "xp" if xp.shape[0] == 1 else "no table"
        geo = I.launch_geometry(xp, fp, q)
        print(f"kernel batched_interp {name} ({B} rows, L={L}, Q={Q}, shared {shared}): bitwise equal "
              f"to plain, NaN out {int(torch.isnan(got).sum())}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {n_bytes / 1e9:.4f} GB), "
              f"{n_bytes / ms / 1e9:.3f} TB/s moved; {'staged' if geo['staged'] else 'device memory'}, "
              f"{geo['threads']} threads a block, {geo['smem_bytes']} B shared a block, "
              f"{geo['blocks_per_sm']} resident blocks an SM, grid {geo['grid']}")
        if name == "config 9b call 1":  # the main path's first call goes in the JSON line
            results["batched_interp"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del xp, fp, q, got
    return results


def ptxas_of(log, kernel):
    """Registers and spills that ``-Xptxas -v`` reported for the first
    kernel whose mangled name holds ``kernel``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            spill = used = ""
            for later in lines[i + 1:]:
                if "spill stores" in later:
                    spill = later.strip()
                if "Used" in later and "registers" in later:
                    used = later.split(":", 1)[-1].strip()
                    break
            return f"{used}; {spill}"
    return f"no ptxas entry for {kernel}"


# the trial switches of csrc/slide_sort.cu, csrc/interp.cu and
# csrc/rank_map.cu, each built as a variant and timed beside the default
# build by ``--trials``
TRIALS = {
    "slide_sort": (("8 cells a block", ("SDT_K5_CELLS_PER_BLOCK=8",)),
                   ("buckets loaded a step ahead", ("SDT_K5_PREFETCH=1",)),
                   ("no floor on resident blocks", ("SDT_K5_MIN_BLOCKS=1",)),
                   ("at least 8 resident blocks an SM", ("SDT_K5_MIN_BLOCKS=8",))),
    "interp": (("staged wherever it fits", ("SDT_K6_ROUTE=1",)),
               ("device memory at every shape", ("SDT_K6_ROUTE=2",)),
               ("staged, 256 threads a block", ("SDT_K6_ROUTE=1", "SDT_K6_THREADS=256")),
               ("staged, 512 threads a block", ("SDT_K6_ROUTE=1", "SDT_K6_THREADS=512"))),
    "rank_map": (("one key a thread on the packed route", ("SDT_RANK_PACKED_ITEMS=1",)),
                 ("two keys a thread on the packed route", ("SDT_RANK_PACKED_ITEMS=2",)),
                 ("512 threads a packed block", ("SDT_RANK_PACKED_THREADS=512",)),
                 ("compares as the compiler forms them", ("SDT_RANK_COUNT=1",)),
                 ("K1 with the stable rank", ("SDT_K1_STABLE=1",)),
                 ("K1's packed route up to 256", ("SDT_K1_SHORT_MAX=256",)),
                 ("K2's packed route up to 64", ("SDT_K2_SHORT_MAX=64",)),
                 ("every L on the radix routes", ("SDT_K1_SHORT_MAX=0", "SDT_K2_SHORT_MAX=0")),
                 ("run ends by a shuffle scan", ("SDT_RANK_RUN_END=0",)),
                 ("no floor on K2's warp route's resident blocks", ("SDT_RANK_WARP_MIN_BLOCKS=1",)),
                 ("K2's warp route at 6 resident blocks an SM", ("SDT_RANK_WARP_MIN_BLOCKS=6",)),
                 ("the search route above the packed route", ("SDT_K2_SEARCH_MIN=257",))),
}


def trials(dev, sources):
    """``--trials [source ...]``: every variant of ``TRIALS`` (of the named
    sources, or all) against the default build of its source, K5 at config
    5, K6 at config 8's fut block and config 9b's two calls, K1 and K2 at
    config 2's and config 5's K2 shape, K2 at config 9a's rows and at
    20-year daily rows (the block route): outputs
    bitwise equal to the default's, CUDA-event times in turns (default,
    each variant, default again) and each launch's shape."""
    import concurrent.futures

    import torch

    from skdownscale_tpu_torch.kernels import build
    from skdownscale_tpu_torch.kernels import interp as I
    from skdownscale_tpu_torch.kernels import rank_map as K
    from skdownscale_tpu_torch.kernels import slide_sort as S
    from skdownscale_tpu_torch.models.batched import GROUP_CHUNK
    from skdownscale_tpu_torch.models.slide import build_slide_plan
    from skdownscale_tpu_torch.utils.timeindex import TimeIndex, padded_doy_groups

    unknown = set(sources) - set(TRIALS)
    _check(not unknown, f"--trials: no trials for {sorted(unknown)}; sources {sorted(TRIALS)}")
    sources = sources or list(TRIALS)
    jobs = [(src, label, defines) for src in sources
            for label, defines in (("default", ()), *TRIALS[src])]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {(src, label): pool.submit(build.build, src, defines) for src, label, defines in jobs}
        builds = {key: f.result() for key, f in futures.items()}
    libs = {key: ctypes.CDLL(res.path) for key, res in builds.items()}
    print(f"trials: {len(jobs)} builds in {time.perf_counter() - t0:.2f} s")
    modules = {"slide_sort": S, "interp": I, "rank_map": K}
    for src, label, _ in jobs:
        modules[src].declare(libs[(src, label)])

    def turns(src, run, check, describe, kernel):
        """``kernel``: the ptxas fragment, or a function of the build's
        label giving it."""
        names = ["default"] + [label for label, _ in TRIALS[src]] + ["default"]
        want = run(libs[(src, "default")])
        torch.cuda.synchronize()
        for label in names[1:-1]:
            check(run(libs[(src, label)]), want, label)
        for i, label in enumerate(names):
            ms = cuda_ms(lambda: run(libs[(src, label)]), iters=10, warmup=2)
            again = " (again)" if i == len(names) - 1 else ""
            frag = kernel(label) if callable(kernel) else kernel
            print(f"trial {src} {label}{again}: {ms:.4f} ms; {describe(libs[(src, label)])}; "
                  f"{ptxas_of(builds[(src, label)].log, frag)}")

    rng = np.random.default_rng(SEED)
    if "slide_sort" in sources:
        ti = TimeIndex.from_pandas(daily_index())
        plan = build_slide_plan(padded_doy_groups(ti), np.arange(31))
        y = adversarial(rng, D_CELLS, len(ti))
        y[rng.random(D_CELLS) < 0.01] = np.nan
        yd = torch.from_numpy(y).to(dev)
        del y
        n_rows = -(-len(plan.consulted) // GROUP_CHUNK["daily"]) * GROUP_CHUNK["daily"]
        print(f"trials K5 config 5 ({D_CELLS} cells x {len(ti)} days, Wp={len(plan.w0_idx)}, "
              f"BW={plan.add_idx.shape[1]})")
        items = S.launch_geometry(plan)["items"]
        turns("slide_sort", lambda lib: S.launch(lib, yd, plan, n_rows),
              lambda got, want, label: bitwise_err(got, want, f"K5 trial {label}"),
              lambda lib: str(S.launch_geometry(plan, lib)),
              f"slide_sorted_windows_kernelILi{items}ELb0E")
        del yd

    if "interp" in sources:
        g = torch.Generator(device=dev).manual_seed(SEED)
        cases = [("config 8 fut block", mbcn_interp_inputs(dev)),
                 ("config 9b call 1", interp_tables(g, dev, Q_CELLS, Q_FIT, Q_PRED, 1)),
                 ("config 9b call 2", interp_tables(g, dev, Q_CELLS, Q_FIT, Q_PRED, 2))]
        for name, (xp, fp, q) in cases:
            print(f"trials K6 {name} ({q.shape[0]} rows, L={xp.shape[1]}, Q={q.shape[1]})")
            turns("interp", lambda lib: I.launch(lib, xp, fp, q),
                  lambda got, want, label: bitwise_err(got, want, f"K6 {name} trial {label}"),
                  lambda lib: str(I.launch_geometry(xp, fp, q, lib)), "batched_interp_staged_kernel")
        del cases

    if "rank_map" in sources:
        c5_rows, c5_g, c5_l = config5_k2_shape()
        cases = [("count_sort_segments", "config 2", N_CELLS, 12, 40),
                 ("rank_map_segments", "config 2", N_CELLS, 12, 40),
                 ("count_sort_segments", "config 5", c5_rows, c5_g, c5_l),
                 ("rank_map_segments", "config 5", c5_rows, c5_g, c5_l),
                 ("rank_map_segments", "config 9a rows", 62_245, 1, Q_PRED),
                 ("rank_map_segments", "20-year daily rows", 8_192, 1, D_TIME)]
        for kernel, name, B, G, L in cases:
            x = torch.from_numpy(adversarial(rng, B * G, L).reshape(B, G * L)).to(dev)
            res = torch.from_numpy(rng.normal(0.0, 1.0, (B * G, L)).astype(np.float32)).to(dev)
            res = torch.sort(res, dim=1).values.reshape(B, G * L)
            if kernel == "count_sort_segments":
                def run(lib):
                    return K.launch_count_sort(lib, x, L)
            else:
                def run(lib):
                    return K.launch_rank_map(lib, x, res, L)
            print(f"trials {kernel} {name} (B={B}, G={G}, L={L})")
            turns("rank_map", run,
                  lambda got, want, label: bitwise_err(got, want, f"{kernel} {name} trial {label}"),
                  lambda lib: str(K.launch_geometry(kernel, L, lib)),
                  lambda label: rank_map_ptxas(kernel, K.launch_geometry(
                      kernel, L, libs[("rank_map", label)])))
            del x, res


def quantile_grid(rng, n_cells, side, n_fit, n_pred, y_too=True):
    """x (fit), y (fit) and x (predict; None for ``n_pred=None``) daily
    float32 grids as bench.py:619-626, (time, lat, lon) with about 5% NaN
    cells."""
    import pandas as pd

    from skdownscale_tpu_torch.xlite import DataArray

    idx = pd.date_range("1990-01-01", periods=n_fit, freq="D")
    nan_cells = rng.random(n_cells) < NAN_CELL_SHARE
    dims = ("time", "lat", "lon")

    def grid(index, loc, sd):
        seas = (10.0 * np.sin(2 * np.pi * (index.dayofyear.to_numpy() - 1) / 365.25)).astype(np.float32)
        a = rng.standard_normal((len(index), n_cells), dtype=np.float32)
        a *= sd
        a += (loc + seas)[:, None]
        a[:, nan_cells] = np.nan
        coords = {"time": index, "lat": np.arange(side), "lon": np.arange(side)}
        return DataArray(a.reshape(len(index), side, side), dims, coords)

    X = grid(idx, 283.0 + 1.5, 2.0)
    Y = grid(idx, 282.0, 1.8) if y_too else None
    Xq = grid(pd.date_range("2050-01-01", periods=n_pred, freq="D"), 283.6, 2.0) if n_pred else None
    return X, Y, Xq, nan_cells


def check_against_cpu(label, got, X, Y, Xq, nan_cells, make_model, apply, rng, n_ref):
    """NaN cells stay NaN, valid cells finite, and ``n_ref`` valid cells agree
    with the port's CPU float64 path within the stated tolerance."""
    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.xlite import DataArray

    T = got.shape[0]
    got = got.reshape(T, -1)
    _check(np.isnan(got[:, nan_cells]).all(), f"{label}: a NaN cell came out with values")
    _check(np.isfinite(got[:, ~nan_cells]).all(), f"{label}: a valid cell came out with NaN or inf")
    valid = np.nonzero(~nan_cells)[0]
    ids = np.sort(rng.choice(valid, min(n_ref, valid.size), replace=False))
    n_ref = ids.size

    def cells(A):
        if A is None:
            return None
        v = A.values.reshape(A.values.shape[0], -1)[:, ids].astype(np.float64)
        return DataArray(v, ("time", "cell"), {"time": A.coords["time"], "cell": np.arange(n_ref)})

    ref_model = sdt.PointWiseDownscaler(make_model(), device="cpu")
    ref_model.fit(cells(X), *([cells(Y)] if Y is not None else []))
    ref = getattr(ref_model, apply)(cells(Xq)).values.reshape(T, n_ref)
    d = np.abs(got[:, ids].astype(np.float64) - ref).ravel()
    p999, dmax, share = float(np.quantile(d, 0.999)), float(d.max()), float(np.mean(d > 1e-3))
    lim_p999, lim_share, lim_max = TOL_Q
    print(f"{label}: {n_ref} cells vs CPU float64: max |diff| {dmax:.6g} K, p99.9 {p999:.6g} K, "
          f"p99 {float(np.quantile(d, 0.99)):.6g} K, share above 1e-3 K {share:.6g} "
          f"(limits p99.9 <= {lim_p999:g}, share <= {lim_share:g}, max <= {lim_max:g})")
    _check(p999 <= lim_p999 and share <= lim_share and dmax <= lim_max,
           f"{label}: the GPU output is outside the stated tolerance of the CPU float64 path")


def run_registry_grid(label, make_model, X, Y, Xq, nan_cells, apply, card, dev, rng, n_ref):
    """Warm-up and one timed ``PointWiseDownscaler`` fit + ``apply``
    (predict or transform) on the card, with the launch counts set to 0
    just before the timed run and read just after; then the CPU float64
    check, wall, cells/s, peak memory and the stages.  Returns the
    launches."""
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import LAUNCHES

    C = nan_cells.size

    def run():
        m = sdt.PointWiseDownscaler(make_model(), device=dev)
        m.fit(X, *([Y] if Y is not None else []))
        return getattr(m, apply)(Xq)

    run()  # warm-up: CUDA context, cached tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    got = np.asarray(out.values)
    del out
    check_against_cpu(label, got, X, Y, Xq, nan_cells, make_model, apply, rng, n_ref)
    print(f"{label}: PointWiseDownscaler fit ({X.values.shape[0]} steps) + {apply} "
          f"({Xq.values.shape[0]} steps) on {C} cells: wall {wall:.4f} s, {C / wall:.1f} cells/s "
          f"(host pack, copies and unpack included); peak device memory {peak / 2**30:.3f} GiB; "
          f"launches {launches}; card {card}")
    stages = registry_stages(X, Y, Xq, dev, make_model, apply)
    print(f"{label}: stages of one fit + {apply} (ms, host clock, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f"; card {card}")
    return launches


def registry_stages(X, Y, Xq, dev, make_model, apply):
    """The runner's steps one by one for a registry model (no host planning):
    packing, copies, the fit and apply stages and the unpack; then the device
    time of the fit and apply cores by CUDA events and the apply core's
    largest kernels by ``torch.profiler``."""
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.models import batched
    from skdownscale_tpu_torch.utils import native

    m = sdt.PointWiseDownscaler(make_model(), device=dev)
    est = m._model
    t = {}
    lap = lapper(t)
    packs = [lap("pack grid", lambda A=A: m._pack(m._to_feature_x(A))) if A is not None else None
             for A in (X, Y, Xq)]
    ids = lap("cell mask", lambda: np.nonzero(native.valid_mask(packs[0]["flat"][0, 0]))[0].astype(np.int32))
    hosts = [lap("compact cells", lambda p=p: native.pack_compact(p["flat"], ids)) if p is not None else None
             for p in packs]
    xd, yd, xqd = [lap("host to device", lambda h=h: torch.from_numpy(h).to(dev)) if h is not None else None
                   for h in hosts]
    yd = yd[:, :, 0] if yd is not None else None
    idx, idx_p = packs[0]["index"], packs[2]["index"]

    def fit_core():
        return batched.batched_fit(est, idx, xd, yd)

    state = lap("fit", fit_core)

    def apply_core():
        if apply == "predict":
            return batched.batched_predict(est, state, idx, xqd, idx_p)
        return batched.batched_transform(est, state, idx, xqd, idx_p, apply)

    out = lap(apply, apply_core)
    host = lap("device to host", lambda: out.cpu().numpy())
    lap("scatter cells", lambda: native.unpack_scatter(host.reshape(len(ids), -1, 1), ids, packs[2]["n_cells"]))
    t["fit device"] = cuda_ms(fit_core, iters=5, warmup=1)
    t[f"{apply} device"] = cuda_ms(apply_core, iters=5, warmup=1)
    print_top_kernels(apply, apply_core)
    return t


def k2_rows_time(X, nan_cells, dev):
    """K2 with one segment per row at config 9a's shape (valid cells x 730),
    on that phase's own predict series, against its plain version."""
    import torch

    from skdownscale_tpu_torch.kernels import rank_map as K

    x = X.values.reshape(X.values.shape[0], -1)[:, ~nan_cells]
    q = torch.from_numpy(np.ascontiguousarray(x.T)).to(dev)
    res = torch.sort(q, dim=1).values.contiguous()
    L = q.shape[1]
    got = K.rank_map_segments(q, res, L)
    torch.cuda.synchronize()
    err = bitwise_err(got, K.rank_map_segments_plain(q, res, L), f"K2 rows L={L}")
    ms = cuda_ms(lambda: K.rank_map_segments(q, res, L), iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: K.rank_map_segments_plain(q, res, L), iters=10, warmup=2)
    sort_ms = cuda_ms(lambda: torch.sort(q, dim=-1), iters=10, warmup=2)
    b_ms, b_by = bound(12 * q.numel(), q.numel() * np.log2(L))
    return q.shape[0], L, err, ms, plain_ms, b_ms, b_by, sort_ms


def long_rows_phase(rng, card, dev):
    """The daily series of 1950-2100 (L = 55,152, K2's search route):
    ``PointWiseDownscaler(QuantileMapper(detrend=True))`` fit + transform on
    a small grid of that length on the card, K2 launched, NaN cells NaN and
    every cell against the CPU float64 path.  (K2 itself is held bitwise at
    LONG_SHAPE in the kernel phase.)"""
    import pandas as pd
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.xlite import DataArray

    label = "long rows"
    index = pd.date_range("1950-01-01", "2100-12-31", freq="D")
    T = len(index)
    _check(T == LONG_SHAPE[2], f"{label}: {T} days, not {LONG_SHAPE[2]}")
    nan_cells = np.zeros(LONG_CELLS, bool)
    nan_cells[rng.choice(LONG_CELLS, 3, replace=False)] = True
    seas = (10.0 * np.sin(2 * np.pi * (index.dayofyear.to_numpy() - 1) / 365.25)).astype(np.float32)
    trend = np.linspace(0.0, 3.0, T, dtype=np.float32)
    a = (283.0 + seas + trend)[:, None] + 2.0 * rng.standard_normal((T, LONG_CELLS), dtype=np.float32)
    a[:, nan_cells] = np.nan
    coords = {"time": index, "lat": np.arange(LONG_SIDE), "lon": np.arange(LONG_SIDE)}
    X = DataArray(a.reshape(T, LONG_SIDE, LONG_SIDE), ("time", "lat", "lon"), coords)

    def make_model():
        return sdt.QuantileMapper(detrend=True)

    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    got = np.asarray(sdt.PointWiseDownscaler(make_model(), device=dev).fit(X).transform(X).values)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _check(launches.get("rank_map_segments", 0) >= 1, f"{label}: K2 was not launched: {launches}")
    check_against_cpu(label, got, X, None, X, nan_cells, make_model, "transform", rng, LONG_CELLS)
    print(f"{label}: PointWiseDownscaler(QuantileMapper(detrend=True)) fit + transform of "
          f"{LONG_CELLS} cells x {T} days (1950-01-01 to 2100-12-31): wall {wall:.4f} s (the first "
          f"run: no warm-up); launches {launches}; card {card}")


def config3_phase(rng, card, dev):
    """QDM at 16,384 cells: fit over 3,650 days, predict 3,650 days (the
    identity branch) and 1,825 days (host bracket tables).  No kernel runs."""
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import LAUNCHES

    X, Y, Xq, nan_cells = quantile_grid(rng, E_CELLS, E_SIDE, E_FIT, E_PRED)

    def make():
        return sdt.EquidistantCdfMatcher(kind="difference", extrapolate="both")

    for name, Q in (("equal length (identity branch)", X), ("1,825 days (bracket tables)", Xq)):
        def run(Q=Q):
            m = sdt.PointWiseDownscaler(make(), device=dev)
            return m.fit(X, Y).predict(Q)

        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_against_cpu(f"config 3 {name}", np.asarray(out.values), X, Y, Q, nan_cells, make,
                          "predict", rng, 256)
        print(f"config 3 {name}: PointWiseDownscaler fit ({E_FIT} days) + predict "
              f"({Q.values.shape[0]} days) on {E_CELLS} cells: wall {wall:.4f} s, "
              f"{E_CELLS / wall:.1f} cells/s; peak device memory {peak / 2**30:.3f} GiB; "
              f"kernel launches {launches} (none expected); card {card}")


def gard_arrays(rng, C, n, m, f):
    """bench.py:1059-1064's GARD data as float32 arrays: X ~ N(10, 3),
    y = 0.2 N(10, 3) + 13, queries ~ N(10, 3)."""
    X = rng.standard_normal((C, n, f), dtype=np.float32) * 3.0 + 10.0
    y = rng.standard_normal((C, n), dtype=np.float32) * 0.6 + 15.0
    Xq = rng.standard_normal((C, m, f), dtype=np.float32) * 3.0 + 10.0
    return X, y, Xq


def k7_ops(C, n, m, f, k):
    """float32 operations of K7 on these inputs: 3f - 1 a distance, and
    about 4 a selected analog for the statistics."""
    return C * m * (n * (3 * f - 1) + 4 * k)


def k8_ops(C, n, m, f, k, newton_queries, n_iter=8):
    """float32 operations of K8: the distances, 2 per statistic row a
    selected analog, and for each query whose analogs are neither all above
    nor all below the threshold (the kernel skips the others) n_iter Newton
    passes over its k analogs."""
    P = f + 1
    rows = 1 + f + f * (f + 1) // 2 + 1 + f + 1
    per_member = 2 * f + 7 + 2 * P + 3 * P * (P + 1) // 2
    return C * m * (n * (3 * f - 1) + 2 * rows * k) + newton_queries * n_iter * k * per_member


def within(got, want, rtol, atol, what):
    """Max |got - want| over values finite in both; fails unless the NaN
    positions agree and every value is within atol + rtol |want|."""
    import torch

    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    _check(torch.equal(nan_g, nan_w), f"{what}: NaN positions differ")
    g, w = got[~nan_g].double(), want[~nan_w].double()
    d = (g - w).abs()
    _check(bool((d <= atol + rtol * w.abs()).all()),
           f"{what}: kernel and plain version differ by {float(d.max())} (rtol {rtol}, atol {atol})")
    return float(d.max()) if d.numel() else 0.0


def gard_kernel_phase(rng, dev):
    """K7 and K8 against their plain versions at config 4's shape, and timed,
    each with its launch geometry (warps a block, resident warps an SM).
    K7: every kind with and without the threshold (k = 1 for best analog,
    as the model runs it); the exceedance probability and the best / sample
    analog bitwise, mean, weighted mean and deviation within rtol 1e-5 +
    atol 1e-5 (sums of 200 float32 terms in another order).  K8 at f = 1,
    2, 3, 5 with the threshold of config 4b, and at f = 2 without one and
    with thresh = 15.0 (half the analogs exceed, so every query runs the
    Newton fit): the count row bitwise, the other sums within rtol 1e-5 +
    atol 1e-3 (up to 200 centred terms of |x| < 20), the probability within
    5e-4 (the JAX package's own kernel-vs-gather tolerance)."""
    import torch

    from skdownscale_tpu_torch.kernels import knn as KN

    C, n, m, k = G_CELLS, G_FIT, G_PRED, G_K

    def geometry(kernel, f, kk):
        g = KN.launch_geometry(kernel, C, n, m, f, kk)
        return (f"{'staged' if g['staged'] else 'global'}, {g['warps']} warps a block, "
                f"{g['smem_bytes']} B shared a block, {g['resident_warps']} resident warps an SM")

    results = {}
    X, y, Xq = (torch.from_numpy(a).to(dev) for a in gard_arrays(rng, C, n, m, G_F))
    rand = torch.from_numpy(rng.integers(0, k, (C, m)).astype(np.int32)).to(dev)
    for kind in KN.KINDS:
        for thresh in (None, 13.0):
            kk = 1 if kind == "best_analog" else k
            args = (X, y, Xq, rand)
            kw = dict(k=kk, kind=kind, thresh=thresh)
            got = KN.pure_analog_stats(*args, **kw)
            torch.cuda.synchronize()
            want = KN.pure_analog_stats_plain(*args, **kw)
            bitwise_err(got[..., 1].contiguous(), want[..., 1].contiguous(), f"K7 {kind} {thresh} prob")
            if kind in ("best_analog", "sample_analogs"):
                bitwise_err(got[..., 0].contiguous(), want[..., 0].contiguous(), f"K7 {kind} {thresh} pred")
            err = within(got, want, 1e-5, 1e-5, f"K7 {kind} thresh={thresh}")
            ms = cuda_ms(lambda: KN.pure_analog_stats(*args, **kw), iters=5, warmup=1)
            plain_ms = cuda_ms(lambda: KN.pure_analog_stats_plain(*args, **kw), iters=2, warmup=1)
            n_bytes = 4 * (X.numel() + y.numel() + Xq.numel() + rand.numel() + got.numel())
            b_ms, b_by = bound(n_bytes, k7_ops(C, n, m, G_F, kk))
            print(f"kernel pure_analog_stats {kind} thresh={thresh} ({C} cells, n={n}, m={m}, f={G_F}, "
                  f"k={kk}): max |diff| {err:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), {C * m / ms / 1e3:.3f} M queries/s; "
                  f"{geometry('pure_analog_stats', G_F, kk)}")
            if (kind, thresh) == ("mean_analogs", 13.0):  # config 4a goes in the JSON line
                results["pure_analog_stats"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            del got, want
    del X, y, Xq, rand
    for f, thresh in ((1, 13.0), (2, 13.0), (3, 13.0), (5, 13.0), (2, None), (2, 15.0)):
        X, y, Xq = (torch.from_numpy(a).to(dev) for a in gard_arrays(rng, C, n, m, f))
        kw = dict(k=k, thresh=thresh)
        stats, prob, _, _ = KN.analog_regression_stats(X, y, Xq, **kw)
        torch.cuda.synchronize()
        ws, wp, _, _ = KN.analog_regression_stats_plain(X, y, Xq, **kw)
        bitwise_err(stats[..., 0].contiguous(), ws[..., 0].contiguous(), f"K8 f={f} {thresh} count")
        err_s = within(stats, ws, 1e-5, 1e-3, f"K8 f={f} thresh={thresh} stats")
        err_p = within(prob, wp, 0.0, 5e-4, f"K8 f={f} thresh={thresh} prob")
        ms = cuda_ms(lambda: KN.analog_regression_stats(X, y, Xq, **kw), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: KN.analog_regression_stats_plain(X, y, Xq, **kw), iters=2, warmup=1)
        count = stats[..., 0]
        newton = int(((count > 0) & (count < k)).sum()) if thresh is not None else 0
        n_bytes = 4 * (X.numel() + y.numel() + Xq.numel() + stats.numel() + prob.numel())
        b_ms, b_by = bound(n_bytes, k8_ops(C, n, m, f, k, newton))
        print(f"kernel analog_regression_stats f={f} thresh={thresh} ({C} cells, n={n}, m={m}, k={k}, "
              f"{newton} queries with a Newton fit): max |diff| stats {err_s:.3g}, prob {err_p:.3g}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"{geometry('analog_regression_stats', f, k)}")
        if (f, thresh) == (2, 13.0):  # config 4b goes in the JSON line
            results["analog_regression_stats"] = {"max_abs_err": max(err_s, err_p), "ms": ms,
                                                  "plain_ms": plain_ms, "bound_ms": b_ms,
                                                  "bound_by": b_by, "library_ms": None}
        del X, y, Xq, stats, prob, ws, wp
    return results


def gard_grid(rng):
    """Config 4's grid as a two-variable daily Dataset: (time, lat, lon),
    fit over 3,650 days from 1990-01-01, predict over 365 days, about 5% NaN
    cells."""
    import pandas as pd

    from skdownscale_tpu_torch.xlite import DataArray, Dataset

    idx = pd.date_range("1990-01-01", periods=G_FIT, freq="D")
    idx_p = pd.date_range("2000-01-01", periods=G_PRED, freq="D")
    nan_cells = rng.random(G_CELLS) < NAN_CELL_SHARE
    dims = ("time", "lat", "lon")

    def field(T, loc, sd):
        a = rng.standard_normal((T, G_CELLS), dtype=np.float32) * sd + loc
        a[:, nan_cells] = np.nan
        return a.reshape(T, G_LAT, G_LON)

    def coords(index):
        return {"time": index, "lat": np.arange(G_LAT), "lon": np.arange(G_LON)}

    X = Dataset({f"x{j}": DataArray(field(G_FIT, 10.0, 3.0), dims, coords(idx)) for j in range(G_F)})
    Y = DataArray(field(G_FIT, 15.0, 0.6), dims, coords(idx))
    Xq = Dataset({f"x{j}": DataArray(field(G_PRED, 10.0, 3.0), dims, coords(idx_p)) for j in range(G_F)})
    return X, Y, Xq, nan_cells


def gard_check_against_cpu(label, got, X, Y, Xq, nan_cells, make_model, rng):
    """Three outputs (time, variable, cell); NaN cells NaN; in valid cells
    NaN only where the model gives it (PureAnalog's error where an analog is
    below the threshold, AnalogRegression's pred and error where none is
    above); ``G_REF_CELLS`` valid cells against the port's CPU float64 path
    within ``TOL_GARD``."""
    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.xlite import DataArray, Dataset

    T = got.shape[0]
    _check(got.shape == (T, 3, G_LAT, G_LON), f"{label}: output shape {got.shape}")
    got = got.reshape(T, 3, -1)
    _check(np.isnan(got[:, :, nan_cells]).all(), f"{label}: a NaN cell came out with values")
    valid = got[:, :, ~nan_cells]
    _check(np.isfinite(valid[:, 1]).all(), f"{label}: an exceedance probability is not finite")
    nan_ok = valid[:, 1] < 1.0 if label.startswith("config 4a") else valid[:, 1] == 0.0
    for o in (0, 2):
        bad = ~np.isfinite(valid[:, o]) & ~(np.isnan(valid[:, o]) & nan_ok)
        _check(not bad.any(), f"{label}: output {o} not finite where the model gives a number")
    ids = np.sort(rng.choice(np.nonzero(~nan_cells)[0], G_REF_CELLS, replace=False))

    def cells(A):
        def one(a):
            v = a.values.reshape(a.values.shape[0], -1)[:, ids].astype(np.float64)
            return DataArray(v, ("time", "cell"), {"time": a.coords["time"], "cell": np.arange(ids.size)})

        return Dataset({k: one(a) for k, a in A.data_vars.items()}) if hasattr(A, "data_vars") else one(A)

    ref = sdt.PointWiseDownscaler(make_model(), device="cpu").fit(cells(X), cells(Y)).predict(cells(Xq))
    ref = ref.values
    mine = got[:, :, ids].astype(np.float64)
    nan_mismatch = float(np.mean(np.isnan(mine) != np.isnan(ref)))
    both = ~np.isnan(mine) & ~np.isnan(ref)
    d = np.abs(mine - ref)[both]
    p999, share = float(np.quantile(d, 0.999)), float(np.mean(d > 1e-3))
    per_output = ", ".join(
        f"{name} max {float(np.abs(mine[:, o] - ref[:, o])[both[:, o]].max()):.6g}"
        for o, name in enumerate(("pred", "exceedance_prob", "prediction_error"))
    )
    lim_p999, lim_share, lim_nan = TOL_GARD
    print(f"{label}: {ids.size} cells vs CPU float64: p99.9 |diff| {p999:.6g}, share above 1e-3 "
          f"{share:.6g}, NaN mismatches {nan_mismatch:.6g} ({per_output}; limits p99.9 <= {lim_p999:g}, "
          f"share <= {lim_share:g}, NaN mismatches <= {lim_nan:g})")
    _check(p999 <= lim_p999 and share <= lim_share and nan_mismatch <= lim_nan,
           f"{label}: the GPU output is outside the stated tolerance of the CPU float64 path")


def gard_grid_phase(label, make_model, kernel, X, Y, Xq, nan_cells, card, dev, rng):
    """Warm-up and one timed ``PointWiseDownscaler`` fit + predict of the
    GARD grid on the card, launches counted from 0 over the timed run; then
    the CPU float64 check, wall, cells/s, peak memory and the stages.
    Returns the launches."""
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import LAUNCHES

    def run():
        return sdt.PointWiseDownscaler(make_model(), device=dev).fit(X, Y).predict(Xq)

    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if kernel is not None:
        _check(launches.get(kernel, 0) >= 1, f"{label}: the path did not launch {kernel}: {launches}")
    else:
        _check(not launches, f"{label}: launched kernels {launches}, none expected")
    _check(list(out.coords["variable"]) == ["pred", "exceedance_prob", "prediction_error"],
           f"{label}: output coordinate {list(out.coords['variable'])}")
    gard_check_against_cpu(label, np.asarray(out.values), X, Y, Xq, nan_cells, make_model, rng)
    print(f"{label}: PointWiseDownscaler fit ({G_FIT} days) + predict ({G_PRED} days) on {G_CELLS} "
          f"cells: wall {wall:.4f} s, {G_CELLS / wall:.1f} cells/s (host pack, copies and unpack "
          f"included); peak device memory {peak / 2**30:.3f} GiB; launches {launches}; card {card}")
    stages = registry_stages(X, Y, Xq, dev, make_model, "predict")
    print(f"{label}: stages of one fit + predict (ms, host clock, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f"; card {card}")
    return launches


def gard_phases(rng, card, dev):
    """Configs 4a, 4b and PureRegression on config 4's grid.  Returns the
    launches of 4a and 4b."""
    import skdownscale_tpu_torch as sdt

    X, Y, Xq, nan_cells = gard_grid(rng)
    print(f"config 4: fit {G_FIT} days, predict {G_PRED} days, {G_CELLS} cells, {G_F} variables, "
          f"float32, {int(nan_cells.sum())} NaN cells")
    l4a = gard_grid_phase(
        "config 4a", lambda: sdt.PureAnalog(n_analogs=G_K, kind="mean_analogs", thresh=13.0),
        "pure_analog_stats", X, Y, Xq, nan_cells, card, dev, rng)
    l4b = gard_grid_phase(
        "config 4b", lambda: sdt.AnalogRegression(n_analogs=G_K, thresh=13.0),
        "analog_regression_stats", X, Y, Xq, nan_cells, card, dev, rng)
    gard_grid_phase("PureRegression", lambda: sdt.PureRegression(thresh=13.0), None,
                    X, Y, Xq, nan_cells, card, dev, rng)
    return l4a, l4b


def k9_rows(rng, rows, L, kind):
    """Seeded float32 (rows, L) for K9: ``gauss`` (rotated-coordinate-like
    N(1, 1.4)), ``windows`` (daily temperatures near 283 K, every third row
    ending in +inf pads, as padded fit windows) or ``adversarial`` (NaN,
    -NaN, +-0, +-inf, heavy ties, all-equal rows, and the NaN whose key is
    INT32_MAX, bits 0x7fffffff, which ties with the TPU kernel's pad key,
    ROADMAP F8)."""
    if kind == "gauss":
        return rng.standard_normal((rows, L), dtype=np.float32) * 1.4 + 1.0
    if kind == "windows":
        x = rng.standard_normal((rows, L), dtype=np.float32) * 2.0 + 283.0
        x[::3, L - L // 30 :] = np.inf
        return x
    x = adversarial(rng, rows, L)
    u = x.view(np.uint32).reshape(-1)
    u[rng.integers(0, u.size, max(1, u.size // 500))] = 0x7FFFFFFF
    return x


# (name, rows, L, data, timed): config 8's rows first (the JSON line)
K9_CASES = [
    ("config 8", M_CELLS * M_D, M_T, "gauss", True),
    ("monthly", M_CELLS * M_D, 304, "gauss", True),
    ("dense daily windows", 512 * 366, 620, "windows", True),
    ("adversarial 3650", 4_096, M_T, "adversarial", False),
    # a warp a row, four rows a block: row counts that leave a block part full
    ("adversarial 304", 6_143, 304, "adversarial", False),
    ("adversarial 620", 3_001, 620, "adversarial", False),
    ("adversarial 1025", 1_001, 1_025, "adversarial", False),  # the shortest block-a-row
    ("adversarial 37", 8_192, 37, "adversarial", False),
    ("adversarial 7", 8_192, 7, "adversarial", False),
    ("adversarial 1", 4_096, 1, "adversarial", False),
    ("adversarial max", 64, None, "adversarial", False),  # L = K9_MAX_LEN
]


def sort_kernel_phase(rng, dev):
    """K9's three forms bitwise against their plain versions (values and
    positions) at every case of K9_CASES, the unsort round trip bitwise,
    and each form timed beside its bound, its plain version, the one
    PyTorch call that computes it and ``torch.sort(keys, stable=True)``."""
    import torch

    from skdownscale_tpu_torch.kernels import sort_rows as S
    from skdownscale_tpu_torch.ops.keys import to_ordered_int

    results = {}
    for name, B, L, kind, timed in K9_CASES:
        L = L or S.K9_MAX_LEN
        x = torch.from_numpy(k9_rows(rng, B, L, kind)).to(dev)
        v = torch.from_numpy(rng.standard_normal((B, L), dtype=np.float32)).to(dev)
        s1 = S.sort_rows(x)
        s2, p2 = S.sort_rows_with_positions(x)
        u = S.unsort_rows(v, p2)
        back = S.unsort_rows(s2, p2)
        torch.cuda.synchronize()
        errs = {"sort_rows": bitwise_err(s1, S.sort_rows_plain(x), f"K9 sort_rows {name}")}
        w2, wp2 = S.sort_rows_with_positions_plain(x)
        errs["sort_rows_with_positions"] = bitwise_err(s2, w2, f"K9 sort_rows_with_positions {name}")
        _check(torch.equal(p2, wp2), f"K9 {name}: positions differ from the stable plain version's")
        errs["unsort_rows"] = bitwise_err(u, S.unsort_rows_plain(v, p2), f"K9 unsort_rows {name}")
        _check(torch.equal(back.view(torch.int32), x.view(torch.int32)),
               f"K9 {name}: unsort of the sorted rows is not the input")
        print(f"kernel K9 {name} ({B} x {L}, {kind}): the three forms bitwise equal to their plain "
              f"versions, positions equal, round trip exact")
        if timed:
            keys = to_ordered_int(x)
            pos = p2.long()
            stable_ms = cuda_ms(lambda: torch.sort(keys, dim=-1, stable=True), iters=10, warmup=2)
            t = {
                "sort_rows": (lambda: S.sort_rows(x), lambda: S.sort_rows_plain(x),
                              lambda: torch.sort(keys, dim=-1), 8),
                "sort_rows_with_positions": (lambda: S.sort_rows_with_positions(x),
                                             lambda: S.sort_rows_with_positions_plain(x), None, 12),
                "unsort_rows": (lambda: S.unsort_rows(v, p2), lambda: S.unsort_rows_plain(v, p2),
                                lambda: torch.empty_like(v).scatter_(-1, pos, v), 12),
            }
            n = B * L
            for form, (kern, plain, one_call, bytes_per) in t.items():
                ms = cuda_ms(kern, iters=10, warmup=2)
                plain_ms = cuda_ms(plain, iters=10, warmup=2)
                lib = stable_ms if one_call is None else cuda_ms(one_call, iters=10, warmup=2)
                # compulsory bytes; a sort compares each element log2 L times
                ops = 0 if form == "unsort_rows" else n * np.log2(max(L, 2))
                b_ms, b_by = bound(bytes_per * n, ops)
                print(f"kernel {form} {name} ({B} x {L}): kernel {ms:.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}), plain {plain_ms:.4f} ms, one PyTorch call {lib:.4f} ms, "
                      f"torch.sort(keys, stable=True) {stable_ms:.4f} ms, {ms / b_ms:.1f}x its bound")
                if name == "config 8":  # the main path's shape goes in the JSON line
                    results[form] = {"max_abs_err": errs[form], "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        del x, v, s1, s2, p2, u, back, w2, wp2
    return results


def mbcn_datasets(rng, n_lat, n_lon, nan_cells):
    """Config 8's three daily Datasets (obs, hist, fut) of M_D variables
    ``v0..``, float32 on (time, lat, lon), as bench.py:731-736: obs ~ N(0,
    S) with unit variances and correlation 0.6, hist ~ 1.4 N(0, 1) + 1.0,
    fut ~ 1.4 N(0, 1) + 1.3; obs and hist from 1990-01-01, fut from
    2050-01-01, 3,650 days each; ``nan_cells`` NaN in all three."""
    import pandas as pd

    from skdownscale_tpu_torch.xlite import DataArray, Dataset

    C = n_lat * n_lon
    corr = 0.6 * np.ones((M_D, M_D)) + 0.4 * np.eye(M_D)
    chol_t = np.linalg.cholesky(corr).T.astype(np.float32)
    dims = ("time", "lat", "lon")

    def ds(start, scale, loc, correlated):
        a = rng.standard_normal((M_T, C, M_D), dtype=np.float32)
        a = (a.reshape(-1, M_D) @ chol_t).reshape(a.shape) if correlated else a * scale + loc
        a[:, nan_cells] = np.nan
        coords = {"time": pd.date_range(start, periods=M_T, freq="D"),
                  "lat": np.arange(n_lat), "lon": np.arange(n_lon)}
        return Dataset({f"v{j}": DataArray(np.ascontiguousarray(a[..., j]).reshape(M_T, n_lat, n_lon),
                                           dims, coords) for j in range(M_D)})

    return ds("1990-01-01", 1.0, 0.0, True), ds("1990-01-01", 1.4, 1.0, False), ds("2050-01-01", 1.4, 1.3, False)


def _ranks(a):
    """Ranks along the time axis of (C, T, d)."""
    return np.argsort(np.argsort(a, axis=1, kind="stable"), axis=1, kind="stable")


def rank_drift(got, want):
    """(C, T, d) float64 host arrays: (share of time steps whose rank in its
    (cell, variable) series differs, p99.9 |diff|, the least Spearman
    correlation of a (cell, variable) series with the other's, the largest
    difference of a cell's correlation matrix across the variables)."""
    rg, rw = _ranks(got), _ranks(want)
    T = got.shape[1]
    d = np.abs(got - want).ravel()
    spearman = 1.0 - 6.0 * ((rg - rw).astype(np.float64) ** 2).sum(axis=1) / (T * (T * T - 1.0))

    def corr(a):
        z = (a - a.mean(axis=1, keepdims=True)) / a.std(axis=1, keepdims=True)
        return np.einsum("ctj,ctk->cjk", z, z) / T

    return (float(np.mean(rg != rw)), float(np.quantile(d, 0.999)), float(spearman.min()),
            float(np.abs(corr(got) - corr(want)).max()))


def _worst(a, b):
    return (max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), max(a[3], b[3]))


def mbcn_depth_drift(correct, blocks, ref64, rots, depths):
    """For each depth r: ``correct(y, xh, xf, rots[:r])`` on ``blocks`` (the
    card's float32 cells) against the same on ``ref64`` (their float64 copy
    on the CPU); the worst :func:`rank_drift` of the hist and fut outputs.
    Returns {r: drift} and {r: the float64 outputs}."""
    out, wants = {}, {}
    for r in depths:
        got = [o.double().cpu().numpy() for o in correct(*blocks, rots[:r])]
        wants[r] = [o.numpy() for o in correct(*ref64, rots[:r])]
        out[r] = _worst(rank_drift(got[0], wants[r][0]), rank_drift(got[1], wants[r][1]))
    return out, wants


def mbcn_controls(correct, blocks, rots, wants):
    """The readings of two wrong paths on the card against the float64 run,
    at MBCN_SHORT_ROT and M_ROT rotations: the rotations rounded to
    bfloat16, and the last rotation dropped.  Returns {(name, r): drift}."""
    import torch

    bf16 = torch.as_tensor(rots).to(torch.bfloat16).double().numpy()
    out = {}
    for r in (MBCN_SHORT_ROT, M_ROT):
        for name, rr in (("bf16 rotations", bf16[:r]), ("last rotation dropped", rots[: r - 1])):
            got = [o.double().cpu().numpy() for o in correct(*blocks, rr)]
            out[name, r] = _worst(rank_drift(got[0], wants[r][0]), rank_drift(got[1], wants[r][1]))
    return out


def mbcn_within(drift, r, group):
    """Whether a :func:`rank_drift` reading after ``r`` rotations meets the
    stated limits: TOL_MBCN_SHORT after MBCN_SHORT_ROT, TOL_MBCN_FULL of the
    grouping after M_ROT."""
    share, p999, spear, dcorr = drift
    if r == MBCN_SHORT_ROT:
        return share <= TOL_MBCN_SHORT[0] and p999 <= TOL_MBCN_SHORT[1]
    return spear >= TOL_MBCN_FULL[group][0] and dcorr <= TOL_MBCN_FULL[group][1]


def mbcn_permutation_check(label, out_h, out_f, blocks, kinds, months):
    """Each output row (cell, variable) is a permutation of the card's own
    QDM margin row, bitwise; per calendar month when ``months`` (obs, hist,
    fut labels) is given.  ``out_*`` are the grid's (c, T, d) host outputs
    of the cells in ``blocks``."""
    import torch

    from skdownscale_tpu_torch.models import mbc as PM
    from skdownscale_tpu_torch.ops.keys import to_ordered_int

    dev = blocks[0].device
    oh, of = (torch.from_numpy(np.ascontiguousarray(o)).to(dev) for o in (out_h, out_f))

    def take(a, idx):
        return a if idx is None else a.index_select(1, torch.as_tensor(idx, device=dev))

    segments = [(None, None, None)] if months is None else [
        tuple(np.nonzero(mo == m)[0] for mo in months) for m in sorted(set(months[1].tolist()))
    ]
    for so, sh, sf in segments:
        mh, mf = PM.mbcn_margins(take(blocks[0], so), take(blocks[1], sh), take(blocks[2], sf), kinds=kinds)
        for out, marg, s in ((oh, mh, sh), (of, mf, sf)):
            got = torch.sort(to_ordered_int(take(out, s).transpose(1, 2).contiguous()), dim=-1).values
            want = torch.sort(to_ordered_int(marg.contiguous()), dim=-1).values
            _check(torch.equal(got, want), f"{label}: an output row is not a permutation of its QDM margins")
    print(f"{label}: every output row is a permutation of the card's own QDM margin row, bitwise "
          f"({len(segments)} segment{'s' if len(segments) > 1 else ''})")


def mbcn_phase(label, rng, card, dev, group):
    """Config 8 (``group=None``) or config 8 monthly: warm-up and one timed
    ``mbcn_grid`` on the card with the launch counts set to 0 just before
    and read just after; K9 and K6 launch counts against the code's, NaN
    cells NaN, the permutation check, the margins and the output by depth
    against the CPU float64 path on M_REF_CELLS cells, wall, cells/s, peak
    memory, and for config 8 the stages.  Returns the launches."""
    import torch

    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.models import mbc as PM

    nan_cells = rng.random(M_CELLS) < NAN_CELL_SHARE
    Y, XH, XF = mbcn_datasets(rng, M_LAT, M_LON, nan_cells)
    print(f"{label}: {M_D} variables, {M_T} days obs / hist / fut, {M_CELLS} cells float32, "
          f"{int(nan_cells.sum())} NaN cells, {M_ROT} rotations, group={group!r}")

    def run():
        return PM.mbcn_grid(Y, XH, XF, n_iterations=M_ROT, group=group, device=dev)

    run()  # warm-up: CUDA context, cuBLAS, the kernels, cached tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    oh, of = run()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    variables = list(Y.data_vars)
    packs = [PM.pack_dataset(ds, variables)[0] for ds in (Y, XH, XF)]
    months = None
    if group == "month":
        months = [np.asarray(ds["v0"].coords["time"].month) for ds in (Y, XH, XF)]
    n_groups = 1 if months is None else len(set(months[1].tolist()))
    for form in K9_FORMS:
        _check(launches.get(form, 0) == K9_PER_CORRECT * n_groups,
               f"{label}: {form} launched {launches.get(form, 0)} times, the code gives "
               f"{K9_PER_CORRECT * n_groups} ({K9_PER_CORRECT} a correction x {n_groups})")
    _check(launches.get("batched_interp", 0) >= M_ROT * n_groups,
           f"{label}: K6 launched {launches.get('batched_interp', 0)} times, fewer than one a rotation")

    out_h, out_f = (np.stack([ds[v].values.reshape(M_T, -1) for v in variables], axis=-1).transpose(1, 0, 2)
                    for ds in (oh, of))
    for name, o in (("hist", out_h), ("fut", out_f)):
        _check(np.isnan(o[nan_cells]).all(), f"{label}: a NaN cell of the {name} output has values")
        _check(np.isfinite(o[~nan_cells]).all(), f"{label}: a valid cell of the {name} output is not finite")
    ids = np.nonzero(~nan_cells)[0]
    kinds = ("difference",) * M_D
    blocks = [PM.to_device(p[ids], dev) for p in packs]
    mbcn_permutation_check(label, out_h[ids], out_f[ids], blocks, kinds, months)
    del blocks

    # the float64 CPU path on M_REF_CELLS valid cells
    ref = np.sort(rng.choice(ids, M_REF_CELLS, replace=False))
    blocks = [PM.to_device(p[ref], dev) for p in packs]
    ref64 = [torch.from_numpy(p[ref].astype(np.float64)) for p in packs]
    rots = PM.mbcn_rotations(M_D, M_ROT, 0)
    if group == "month":
        def correct(y, xh, xf, r):
            return PM.mbcn_correct_monthly(y, xh, xf, *months, r, kinds=kinds)
        depths = (MBCN_SHORT_ROT, M_ROT)
    else:
        def correct(y, xh, xf, r):
            return PM.mbcn_correct(y, xh, xf, r, kinds=kinds)
        depths = (1, MBCN_SHORT_ROT, 5, 10, M_ROT)
        mh, mf = PM.mbcn_margins(*blocks, kinds=kinds)
        wh, wf = PM.mbcn_margins(*ref64, kinds=kinds)
        d = np.concatenate([np.abs(mh.double().cpu().numpy() - wh.numpy()).ravel(),
                            np.abs(mf.double().cpu().numpy() - wf.numpy()).ravel()])
        p999, share, dmax = float(np.quantile(d, 0.999)), float(np.mean(d > 1e-3)), float(d.max())
        lim_p999, lim_share, lim_max = TOL_Q
        print(f"{label}: QDM margins of {M_REF_CELLS} cells vs CPU float64: p99.9 |diff| {p999:.6g}, share "
              f"above 1e-3 {share:.6g}, max {dmax:.6g} (limits {lim_p999:g}, {lim_share:g}, {lim_max:g})")
        _check(p999 <= lim_p999 and share <= lim_share and dmax <= lim_max,
               f"{label}: the card's QDM margins are outside the quantile family's tolerance")
    drift, wants = mbcn_depth_drift(correct, blocks, ref64, rots, depths)
    for r, (share, p999, spear, dcorr) in drift.items():
        print(f"{label}: {M_REF_CELLS} cells after {r} rotation(s) vs CPU float64: share of time steps "
              f"with another rank {share:.6g}, p99.9 |diff| {p999:.6g}, min Spearman {spear:.8f}, max "
              f"|correlation difference| {dcorr:.6g}")
    _check(mbcn_within(drift[MBCN_SHORT_ROT], MBCN_SHORT_ROT, group),
           f"{label}: after {MBCN_SHORT_ROT} rotations the card is outside the stated tolerance "
           f"(share <= {TOL_MBCN_SHORT[0]}, p99.9 <= {TOL_MBCN_SHORT[1]}): {drift[MBCN_SHORT_ROT]}")
    full = _worst(rank_drift(out_h[ref].astype(np.float64), wants[M_ROT][0]),
                  rank_drift(out_f[ref].astype(np.float64), wants[M_ROT][1]))
    print(f"{label}: the grid's output on those cells vs CPU float64 ({M_ROT} rotations): share of time "
          f"steps with another rank {full[0]:.6g}, p99.9 |diff| {full[1]:.6g}, min Spearman "
          f"{full[2]:.8f}, max |correlation difference| {full[3]:.6g} (limits Spearman >= "
          f"{TOL_MBCN_FULL[group][0]:g}, correlation <= {TOL_MBCN_FULL[group][1]:g})")
    _check(mbcn_within(full, M_ROT, group),
           f"{label}: the card's output is outside the stated tolerance of the CPU float64 path")
    # the limits must fail paths that are wrong: each control at one depth at least
    caught = {}
    for (name, r), c in mbcn_controls(correct, blocks, rots, wants).items():
        out = not mbcn_within(c, r, group)
        caught[name] = caught.get(name, False) or out
        print(f"{label}: control '{name}' after {r} rotations vs CPU float64: share of time steps with "
              f"another rank {c[0]:.6g}, p99.9 |diff| {c[1]:.6g}, min Spearman {c[2]:.8f}, max "
              f"|correlation difference| {c[3]:.6g}: {'outside' if out else 'inside'} the limits")
    for name, out in caught.items():
        _check(out, f"{label}: the control '{name}' meets the limits at every depth, so they cannot "
                    f"tell it from the sound path")
    print(f"{label}: mbcn_grid {M_CELLS} cells x {M_T} days x {M_D} variables, {M_ROT} rotations: wall "
          f"{wall:.4f} s, {M_CELLS / wall:.1f} cells/s (host pack, copies and unpack included); peak "
          f"device memory {peak / 2**30:.3f} GiB; launches {launches}; card {card}")
    if group is None:
        stages = mbcn_stages(Y, XH, XF, dev)
        print(f"{label}: stages of one mbcn_grid (ms, host clock, synchronised): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; device share of the wall {stages['correct device'] / (wall * 1e3):.4f}; card {card}")
    return launches


def mbcn_stages(Y, XH, XF, dev):
    """``mbcn_grid``'s steps one by one: pack, compact, copies in, the
    margins, the rotation rounds, the reorder, the copy back and the
    unpack; then the device time of ``mbcn_correct`` by CUDA events and its
    largest kernels by ``torch.profiler``."""
    import torch

    from skdownscale_tpu_torch.models import mbc as PM

    t = {}
    lap = lapper(t)
    variables = list(Y.data_vars)
    packs = [lap("pack", lambda ds=ds: PM.pack_dataset(ds, variables)) for ds in (Y, XH, XF)]
    ids = lap("compact", lambda: PM.valid_cells(*(p[0] for p in packs)))
    hosts = [lap("compact", lambda p=p: np.ascontiguousarray(p[0][ids], dtype=np.float32)) for p in packs]
    yo, xh, xf = (lap("host to device", lambda h=h: torch.from_numpy(h).to(dev)) for h in hosts)
    kinds = ("difference",) * M_D
    rots = torch.as_tensor(PM.mbcn_rotations(M_D, M_ROT, 0), dtype=torch.float32, device=dev)
    lo, hi, w = PM._rank_bracket_dev(M_T, M_T, 0.4, 0.4, dev, torch.float32)
    mh, mf = lap("margins", lambda: PM.mbcn_margins(yo, xh, xf, kinds=kinds))
    zh, zf = lap("rotations", lambda: PM.mbcn_iterate(yo, mh, mf, rots, lo, hi, w))
    oh, of = lap("reorder", lambda: (PM.mbcn_reorder(mh, zh), PM.mbcn_reorder(mf, zf)))
    host = lap("device to host", lambda: (oh.cpu().numpy(), of.cpu().numpy()))

    def unpack():
        for o, p in zip(host, packs[1:]):
            full = np.full_like(p[0], np.nan)
            full[ids] = o
            PM.unpack_dataset(full, p[1], p[2], variables)

    lap("unpack", unpack)

    def core():
        return PM.mbcn_correct(yo, xh, xf, rots, kinds=kinds)

    t["correct device"] = cuda_ms(core, iters=3, warmup=1)
    print_top_kernels("mbcn_correct", core)
    return t


def config8b_phase(rng, card, dev):
    """Config 8b: 16,384 valid cells in 2,048-cell chunks, one timed
    ``mbcn_grid`` run (the kernels are built and warm): launches per chunk,
    NaN cells NaN, valid cells finite, wall and cells/s."""
    import torch

    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.models import mbc as PM

    C = MB_LAT * MB_LON
    nan_cells = np.zeros(C, dtype=bool)
    nan_cells[rng.choice(C, C - MB_VALID, replace=False)] = True
    Y, XH, XF = mbcn_datasets(rng, MB_LAT, MB_LON, nan_cells)
    n_chunks = -(-MB_VALID // MB_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    oh, of = PM.mbcn_grid(Y, XH, XF, n_iterations=M_ROT, cell_chunk_size=MB_CHUNK, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for form in K9_FORMS:
        _check(launches.get(form, 0) == K9_PER_CORRECT * n_chunks,
               f"config 8b: {form} launched {launches.get(form, 0)} times, the code gives "
               f"{K9_PER_CORRECT * n_chunks}")
    for ds in (oh, of):
        for v in ds.data_vars:
            a = ds[v].values.reshape(M_T, -1)
            _check(np.isnan(a[:, nan_cells]).all() and np.isfinite(a[:, ~nan_cells]).all(),
                   f"config 8b: NaN cells or valid cells of {v} came out wrong")
    print(f"config 8b: mbcn_grid {C} cells ({MB_VALID} valid) x {M_T} days x {M_D} variables in "
          f"{n_chunks} chunks of {MB_CHUNK}, {M_ROT} rotations: wall {wall:.4f} s, {C / wall:.1f} "
          f"cells/s ({MB_VALID / wall:.1f} valid cells/s; data made before the clock starts); peak device "
          f"memory {peak / 2**30:.3f} GiB; launches {launches}; card {card}")


# ----------------------------------------------------------------------
# configs 7, 6, the per-cell fallback and config G
# ----------------------------------------------------------------------


class LstsqRegression:
    """Least-squares linear regression with scikit-learn's fit / predict
    API and no batched implementation: the card's machine has no
    scikit-learn, so it stands in for ``sklearn.linear_model.
    LinearRegression`` (the CPU tests run the real one)."""

    def fit(self, X, y):
        A = np.column_stack([np.asarray(X, np.float64), np.ones(len(X))])
        self.coef_ = np.linalg.lstsq(A, np.asarray(y, np.float64).reshape(-1), rcond=None)[0]
        return self

    def predict(self, X):
        return np.column_stack([np.asarray(X, np.float64), np.ones(len(X))]) @ self.coef_


def diff_stats(got, want):
    """(p99.9, max, values) of |got - want| over entries finite in both;
    fails unless both have NaN in the same places."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    _check(np.array_equal(np.isnan(got), np.isnan(want)), "NaN in other places than the CPU path's")
    d = np.abs(got - want)[np.isfinite(want)]
    return float(np.quantile(d, 0.999)), float(d.max()), d


def cpu_subset(A, ids):
    """Cells ``ids`` of a (time, *spatial) DataArray as a float64 (time,
    cell) DataArray."""
    from skdownscale_tpu_torch.xlite import DataArray

    v = A.values.reshape(A.values.shape[0], -1)[:, ids].astype(np.float64)
    return DataArray(v, ("time", "cell"), {"time": A.coords["time"], "cell": np.arange(len(ids))})


def timed_grid_run(label, make_model, X, Y, Xq, apply, card, dev, cells_note=""):
    """Warm-up and one timed ``PointWiseDownscaler`` fit + ``apply`` on the
    card (launch counts set to 0 just before, read just after), the device
    time of the registry's fit and apply cores by CUDA events (one call
    each, on the compacted cells), peak device memory; returns (output,
    launches, wall)."""
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.models import batched
    from skdownscale_tpu_torch.utils import native

    C = int(np.prod(X.values.shape[1:]))

    def run():
        m = sdt.PointWiseDownscaler(make_model(), device=dev)
        m.fit(X, Y)
        return getattr(m, apply)(Xq)

    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = np.asarray(run().values)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    # the registry's cores alone, on the compacted cells, by CUDA events
    m = sdt.PointWiseDownscaler(make_model(), device=dev)
    est = m._model
    packs = [m._pack(m._to_feature_x(A)) for A in (X, Y, Xq)]
    ids = np.nonzero(native.valid_mask(packs[0]["flat"][0, 0]))[0].astype(np.int32)
    xd, yd, xqd = (m._to_device(p["flat"], ids) for p in packs)
    idx, idx_p = packs[0]["index"], packs[2]["index"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    state = batched.batched_fit(est, idx, xd, yd[:, :, 0])
    ev[1].record()
    batched.batched_predict(est, state, idx, xqd, idx_p)
    ev[2].record()
    torch.cuda.synchronize()
    fit_ms, apply_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    del xd, yd, xqd, state
    print(f"{label}: PointWiseDownscaler fit ({X.values.shape[0]} steps) + {apply} "
          f"({Xq.values.shape[0]} steps) on {C} cells{cells_note}: wall {wall:.4f} s, "
          f"{C / wall:.1f} cells/s (host pack, copies and unpack included); device time of the "
          f"registry's fit {fit_ms:.3f} ms and {apply} {apply_ms:.3f} ms (CUDA events, one call "
          f"each); peak device memory {peak / 2**30:.3f} GiB ({peak / (C * X.values.shape[0]):.1f} "
          f"B a (cell, step)); launches {launches}; card {card}")
    return out, launches, wall


def config7_phase(rng, card, dev):
    """Config 7 (BASELINE config 7): ``ZScoreRegressor(window_width=31)`` on
    65,536 cells x 7,305 days, fit and predict on the same record; 512 cells
    against the CPU float64 path within TOL_Z."""
    import skdownscale_tpu_torch as sdt

    X, Y, _, nan_cells = quantile_grid(rng, Z_CELLS, Z_SIDE, D_TIME, None)
    print(f"config 7: grid {D_TIME} days x {Z_CELLS} cells float32, {int(nan_cells.sum())} NaN cells")

    def make():
        return sdt.ZScoreRegressor(window_width=Z_WINDOW)

    got, _, _ = timed_grid_run("config 7", make, X, Y, X, "predict", card, dev)
    got = got.reshape(D_TIME, -1)
    edge = np.zeros(D_TIME, dtype=bool)
    edge[: Z_WINDOW // 2] = edge[D_TIME - Z_WINDOW // 2:] = True  # min_periods = window
    _check(np.isnan(got[:, nan_cells]).all(), "config 7: a NaN cell came out with values")
    _check(np.isnan(got[edge][:, ~nan_cells]).all() and np.isfinite(got[~edge][:, ~nan_cells]).all(),
           "config 7: valid cells are not NaN exactly on the window's edges")
    ids = np.sort(rng.choice(np.nonzero(~nan_cells)[0], Z_REF_CELLS, replace=False))
    ref = sdt.PointWiseDownscaler(make(), device="cpu").fit(cpu_subset(X, ids), cpu_subset(Y, ids))
    ref = ref.predict(cpu_subset(X, ids)).values
    p999, dmax, d = diff_stats(got[:, ids], ref)
    lim_p999, lim_max = TOL_Z
    print(f"config 7: {Z_REF_CELLS} cells vs CPU float64: max |diff| {dmax:.6g} K, p99.9 {p999:.6g} K, "
          f"median {float(np.median(d)):.6g} K (limits p99.9 <= {lim_p999:g}, max <= {lim_max:g})")
    _check(p999 <= lim_p999 and dmax <= lim_max,
           "config 7: the GPU output is outside the stated tolerance of the CPU float64 path")


def arrm_grid(rng):
    """Config 6's data (bench.py:346-351) on 128 x 128 cells x 1,000 days,
    about 5% NaN cells."""
    import pandas as pd

    from skdownscale_tpu_torch.xlite import DataArray

    C = A_SIDE * A_SIDE
    nan_cells = rng.random(C) < NAN_CELL_SHARE
    x = rng.uniform(-10, 15, (A_TIME, C)).astype(np.float32)
    y = (np.where(x < 0, -1.0 * x, np.where(x < 5, 2.0 * x, 10 + 0.5 * (x - 5)))
         + rng.normal(0, 0.3, (A_TIME, C))).astype(np.float32)
    x[:, nan_cells] = y[:, nan_cells] = np.nan
    dims = ("time", "lat", "lon")
    coords = {"time": pd.date_range("1990-01-01", periods=A_TIME, freq="D"),
              "lat": np.arange(A_SIDE), "lon": np.arange(A_SIDE)}
    shape = (A_TIME, A_SIDE, A_SIDE)
    return DataArray(x.reshape(shape), dims, coords), DataArray(y.reshape(shape), dims, coords), nan_cells


def config6_phase(rng, card, dev):
    """Config 6 (BASELINE config 6): ``PiecewiseLinearRegression(
    n_segments=6)`` with ``fit_option="arrm"`` and ``"auto"`` on 16,384
    cells x 1,000 days; 256 cells of each against the CPU float64 path
    (TOL_ARRM for 'arrm', TOL_AUTO for 'auto')."""
    import skdownscale_tpu_torch as sdt

    X, Y, nan_cells = arrm_grid(rng)
    print(f"config 6: grid {A_TIME} days x {A_SIDE * A_SIDE} cells float32, "
          f"{int(nan_cells.sum())} NaN cells")
    ids = np.sort(rng.choice(np.nonzero(~nan_cells)[0], A_REF_CELLS, replace=False))
    y_ref = Y.values.reshape(A_TIME, -1)[:, ids].astype(np.float64)
    for option in ("arrm", "auto"):
        label = f"config 6 {option}"

        def make(option=option):
            return sdt.PiecewiseLinearRegression(n_segments=6, fit_option=option)

        got, _, _ = timed_grid_run(label, make, X, Y, X, "predict", card, dev)
        got = got.reshape(A_TIME, -1)
        _check(np.isnan(got[:, nan_cells]).all() and np.isfinite(got[:, ~nan_cells]).all(),
               f"{label}: NaN cells or valid cells came out wrong")
        ref = sdt.PointWiseDownscaler(make(), device="cpu").fit(cpu_subset(X, ids), cpu_subset(Y, ids))
        ref = ref.predict(cpu_subset(X, ids)).values
        p999, dmax, d = diff_stats(got[:, ids], ref)
        if option == "arrm":
            lim_p999, lim_share, lim_max = TOL_ARRM
            share = float(np.mean(d > lim_p999))
            print(f"{label}: {A_REF_CELLS} cells vs CPU float64: max |diff| {dmax:.6g}, p99.9 "
                  f"{p999:.6g}, share above {lim_p999:g} {share:.6g} (limits p99.9 <= {lim_p999:g}, "
                  f"share <= {lim_share:g}, max <= {lim_max:g})")
            _check(p999 <= lim_p999 and share <= lim_share and dmax <= lim_max,
                   f"{label}: the GPU output is outside the stated tolerance of the CPU float64 path")
            continue
        ssr_card = ((got[:, ids] - y_ref) ** 2).sum(0)
        ssr_cpu = ((ref - y_ref) ** 2).sum(0)
        ratio = ssr_card / ssr_cpu
        rms = np.sqrt(((got[:, ids] - ref) ** 2).mean(0))
        worst = float(np.sqrt(ssr_card / A_TIME).max())
        lim_ratio, lim_rms, lim_worst = TOL_AUTO
        med = float(np.median(np.abs(ratio - 1)))
        print(f"{label}: {A_REF_CELLS} cells vs CPU float64: per-cell SSR ratio quantiles "
              f"(0, 5, 50, 95, 100%) {np.quantile(ratio, [0, 0.05, 0.5, 0.95, 1]).round(6).tolist()}, "
              f"cells within 1% {float(np.mean(np.abs(ratio - 1) <= 0.01)):.4f}, median |ratio - 1| "
              f"{med:.6g}, median per-cell RMS of the prediction difference {float(np.median(rms)):.6g}, "
              f"largest residual RMS on the card {worst:.6g} (limits median |ratio - 1| <= "
              f"{lim_ratio:g}, median RMS <= {lim_rms:g}, every residual RMS <= {lim_worst:g})")
        _check(med <= lim_ratio and float(np.median(rms)) <= lim_rms and worst <= lim_worst,
               f"{label}: the GPU fits are outside the stated tolerance of the CPU float64 path")


def fallback_phase(rng, card, dev):
    """The per-cell object fallback: 256 cells of config 7's grid cut to
    1,825 days through a least-squares regression with scikit-learn's API
    (:class:`LstsqRegression`), then the first 64 of them
    through a TrendAware model whose trend transformer the batched rule
    refuses (each cell's fit on the card by the single-cell API); every
    cell against the CPU float64 path."""
    import pandas as pd
    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.models.base import SingleCellEstimator
    from skdownscale_tpu_torch.xlite import DataArray

    class SubclassedTrend(sdt.LinearTrendTransformer):
        """A trend transformer of another class: the batched rule refuses it."""

    idx = pd.date_range("1990-01-01", periods=F_TIME, freq="D")
    seas = (10.0 * np.sin(2 * np.pi * (idx.dayofyear.to_numpy() - 1) / 365.25)).astype(np.float32)
    x = (283.0 + 1.5 + seas[:, None] + rng.normal(0, 2, (F_TIME, F_CELLS))).astype(np.float32)
    y = (282.0 + seas[:, None] + rng.normal(0, 1.8, (F_TIME, F_CELLS))).astype(np.float32)
    nan_cells = rng.random(F_CELLS) < NAN_CELL_SHARE
    x[:, nan_cells] = y[:, nan_cells] = np.nan
    c = {"time": idx, "cell": np.arange(F_CELLS)}
    ta = [("least-squares regression", LstsqRegression, F_CELLS),
          ("TrendAware with a subclassed trend transformer",
           lambda: sdt.TrendAwareQuantileMappingRegressor(
               sdt.QuantileMappingReressor(extrapolate="both"), SubclassedTrend()), F_TA_CELLS)]
    for name, make, n in ta:
        X = DataArray(x[:, :n], ("time", "cell"), {**c, "cell": np.arange(n)})
        Y = DataArray(y[:, :n], ("time", "cell"), {**c, "cell": np.arange(n)})
        _check(not sdt.models.batched.supports_batched(make()), f"fallback: {name} is batchable")
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        got = sdt.PointWiseDownscaler(make(), device=dev).fit(X, Y).predict(X).values
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        card_device = SingleCellEstimator.single_cell_device
        SingleCellEstimator.single_cell_device = torch.device("cpu")
        try:
            X64, Y64 = (DataArray(a.values.astype(np.float64), a.dims, dict(a.coords)) for a in (X, Y))
            ref = sdt.PointWiseDownscaler(make(), device="cpu").fit(X64, Y64).predict(X64).values
        finally:
            SingleCellEstimator.single_cell_device = card_device
        p999, dmax, d = diff_stats(got, ref)
        valid = int((~nan_cells[:n]).sum())
        lim_p999, lim_max = TOL_FALLBACK
        print(f"fallback {name}: {n} cells ({valid} valid) x {F_TIME} days, host loop: wall {wall:.4f} s, "
              f"{n / wall:.1f} cells/s; every cell vs CPU float64: max |diff| {dmax:.6g} K, p99.9 "
              f"{p999:.6g} K (limits p99.9 <= {lim_p999:g}, max <= {lim_max:g}); launches {launches}; "
              f"card {card}")
        _check(p999 <= lim_p999 and dmax <= lim_max,
               f"fallback {name}: the GPU output is outside the stated tolerance of the CPU float64 path")
        _check(np.isnan(got[:, nan_cells[:n]]).all(), f"fallback {name}: a NaN cell came out with values")


def k6_global_shapes(dev, ladder_args, map_args, card):
    """K6 at config G's two shapes (the ladder: one row of C x T knots and
    the Q plotting positions as queries; the map: every cell row against the
    shared Q-knot ladder) bitwise against its plain version, and timed."""
    import torch

    from skdownscale_tpu_torch.kernels import interp as I

    rows = []
    for name, (xp, fp, q) in (("ladder", ladder_args), ("map", map_args)):
        got = I.batched_interp(xp, fp, q)
        torch.cuda.synchronize()
        err = bitwise_err(got, I.batched_interp_plain(xp, fp, q), f"K6 config G {name}")
        ms = cuda_ms(lambda: I.batched_interp(xp, fp, q), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: I.batched_interp_plain(xp, fp, q), iters=3, warmup=1)
        B, L, Q = q.shape[0], xp.shape[1], q.shape[1]
        # every knot is read (a NaN knot anywhere in a row turns its results
        # NaN), each query once, each output written once
        n_bytes = 4 * (xp.numel() + fp.numel() + q.numel() + got.numel())
        b_ms, b_by = bound(n_bytes, B * Q * (np.ceil(np.log2(L)) + 15))
        geo = I.launch_geometry(xp, fp, q)
        print(f"kernel batched_interp config G {name} ({B} rows, L={L}, Q={Q}): bitwise equal to "
              f"plain (max |diff| {err}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e9:.4f} GB), one PyTorch call: none; "
              f"{'staged' if geo['staged'] else 'device memory'}, {geo['threads']} threads a block, "
              f"{geo['blocks_per_sm']} resident blocks an SM, grid {geo['grid']}; card {card}")
        rows.append((name, ms, plain_ms, b_ms))
    return rows


def configG_phase(rng, card, dev):
    """Config G: ``GlobalDownscaler(GlobalQuantileMapper())`` (Q = 2,048) and
    ``GlobalLinearRegressor`` in both intercept modes on 65,536 cells x
    3,650 days; K6 launched by the ladder fit and by ``transform``; the
    ladders and coefficients against the CPU float64 path on the whole
    grid, the outputs on 512 cells; K6 at the two new shapes.  Returns K6's
    launches in the mapper's fit and transform."""
    from unittest import mock

    import torch

    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.kernels import LAUNCHES
    from skdownscale_tpu_torch.ops import interp as OI

    X, Y, _, nan_cells = quantile_grid(rng, Q_CELLS, Q_SIDE, G_TIME, None)
    C = Q_CELLS
    print(f"config G: grid {G_TIME} days x {C} cells float32, {int(nan_cells.sum())} NaN cells")
    ids = np.sort(rng.choice(np.nonzero(~nan_cells)[0], G_REF_CELLS_OUT, replace=False))
    x64 = np.ascontiguousarray(X.values.reshape(G_TIME, C).T, dtype=np.float64)  # (C, T)
    y64 = np.ascontiguousarray(Y.values.reshape(G_TIME, C).T, dtype=np.float64)

    # the mapper: launches of the fit and of transform, walls, device times
    def fit():
        return sdt.GlobalDownscaler(sdt.GlobalQuantileMapper(), device=dev).fit(X, Y)

    fit().transform(X)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    gd = fit()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fit_k6 = LAUNCHES["batched_interp"]
    LAUNCHES.clear()
    out = gd.transform(X)
    wall = time.perf_counter() - t0
    tr_k6 = LAUNCHES["batched_interp"]
    peak = torch.cuda.max_memory_allocated()
    _check(fit_k6 == 2 and tr_k6 == 1,
           f"config G: K6 launched {fit_k6} times by the fit (2 ladders) and {tr_k6} by transform (1)")
    got = np.moveaxis(np.asarray(out.values), -1, 0).reshape(G_TIME, C)
    _check(np.isnan(got[:, nan_cells]).all() and np.isfinite(got[:, ~nan_cells]).all(),
           "config G: NaN cells or valid cells came out wrong")
    model = gd._model
    xt = torch.from_numpy(x64.astype(np.float32)).to(dev)
    yt = torch.from_numpy(y64.astype(np.float32)).to(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    model.fit(xt, yt)
    ev[1].record()
    model.transform(xt)
    ev[2].record()
    torch.cuda.synchronize()
    print(f"config G: GlobalDownscaler(GlobalQuantileMapper()) Q={G_Q} fit + transform on {C} cells "
          f"x {G_TIME} days: wall {wall:.4f} s (fit {t1 - t0:.4f} s), {C / wall:.1f} cells/s (host "
          f"pack, copies and unpack included); device time of the fit "
          f"{ev[0].elapsed_time(ev[1]):.3f} ms and transform {ev[1].elapsed_time(ev[2]):.3f} ms "
          f"(CUDA events); peak device memory {peak / 2**30:.3f} GiB; K6 launches: fit {fit_k6}, "
          f"transform {tr_k6}; card {card}")

    # the CPU float64 path on the whole grid (ladders), outputs on 512 cells
    ref = sdt.GlobalQuantileMapper(device="cpu").fit(x64, y64)
    st, rst = model.state_, ref.state_
    _check(int(st.n_x) == int(rst.n_x) and int(st.n_y) == int(rst.n_y), "config G: sample counts differ")
    for name in ("x_ladder", "y_ladder"):
        a, b = getattr(st, name).double().cpu().numpy(), getattr(rst, name).numpy()
        p999, dmax, _ = diff_stats(a, b)
        print(f"config G: {name} ({G_Q} quantiles) vs CPU float64 on the whole grid: max |diff| "
              f"{dmax:.6g} K, p99.9 {p999:.6g} K (limit max <= {TOL_G_LADDER:g})")
        _check(dmax <= TOL_G_LADDER, f"config G: {name} outside the stated tolerance")
    want = ref.transform(x64[ids]).numpy().T
    p999, dmax, _ = diff_stats(got[:, ids], want)
    lim_p999, lim_max = TOL_G
    print(f"config G transform: {len(ids)} cells vs CPU float64: max |diff| {dmax:.6g} K, p99.9 "
          f"{p999:.6g} K (limits p99.9 <= {lim_p999:g}, max <= {lim_max:g})")
    _check(p999 <= lim_p999 and dmax <= lim_max, "config G transform: outside the stated tolerance")

    # K6 at its two new shapes, with the arguments the fit's x ladder and
    # transform give it
    real, seen = OI.batched_interp, []

    def record(xp, fp, q):
        seen.append((xp, fp, q))
        return real(xp, fp, q)

    with mock.patch.object(OI, "batched_interp", record):
        model.fit(xt, yt)
        model.transform(xt)
    _check(len(seen) == 3, f"config G: {len(seen)} K6 calls in fit + transform, not 3")
    rows = k6_global_shapes(dev, seen[0], seen[2], card)
    del seen

    # the pooled linear models, both intercept modes
    for cell_intercepts in (False, True):
        label = f"config G linear (cell_intercepts={cell_intercepts})"

        def lin():
            return sdt.GlobalDownscaler(sdt.GlobalLinearRegressor(cell_intercepts=cell_intercepts), device=dev)

        lin().fit(X, Y).predict(X)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = lin().fit(X, Y)
        out = g.predict(X)
        wall = time.perf_counter() - t0
        pred = np.moveaxis(np.asarray(out.values), -1, 0).reshape(G_TIME, C)
        ref = sdt.GlobalLinearRegressor(cell_intercepts=cell_intercepts, device="cpu")
        ref.fit(x64[..., None], y64)
        st, rst = g._model.state_, ref.state_
        coef_rel = float((st.coef.double().cpu() - rst.coef).abs().max() / rst.coef.abs().max())
        icpt = (st.cell_intercept if cell_intercepts else st.intercept[None]).double().cpu().numpy()
        ricpt = (rst.cell_intercept if cell_intercepts else rst.intercept[None]).numpy()
        _, icpt_max, _ = diff_stats(icpt, ricpt)
        want = ref.predict(x64[..., None])[ids].numpy().T
        p999, dmax, _ = diff_stats(pred[:, ids], want)
        lim_coef, lim_icpt, lim_out = TOL_G_LINEAR
        print(f"{label}: fit + predict on {C} cells x {G_TIME} days: wall {wall:.4f} s, {C / wall:.1f} "
              f"cells/s; vs CPU float64 on the whole grid: coef {st.coef.cpu().numpy().tolist()} "
              f"(relative diff {coef_rel:.3g}), intercepts max |diff| {icpt_max:.6g} K; outputs on "
              f"{len(ids)} cells max |diff| {dmax:.6g} K (limits coef <= {lim_coef:g} relative, "
              f"intercepts <= {lim_icpt:g} K, outputs <= {lim_out:g} K); card {card}")
        _check(coef_rel <= lim_coef and icpt_max <= lim_icpt and dmax <= lim_out,
               f"{label}: outside the stated tolerance of the CPU float64 path")
    return fit_k6 + tr_k6, rows


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
        if sys.argv[1:2] == ["--trials"]:
            trials(torch.device("cuda", 0), sys.argv[2:])
            print(card)
            return 0
        t0 = time.perf_counter()
        for name, res in build.build_all().items():
            print(f"build: {res.path} in {res.seconds:.2f} s")
            for line in res.log.splitlines():
                if "registers" in line or "Compiling entry" in line or "spill" in line:
                    print(f"build: {line.strip()}")
        print(f"build: every source in {time.perf_counter() - t0:.2f} s")
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(SEED)
        t_mark = [time.perf_counter()]

        def mark(what):  # the seconds since the last mark, on a line of its own
            now = time.perf_counter()
            print(f"phase: {what} done in {now - t_mark[0]:.1f} s")
            t_mark[0] = now
        kernels = kernel_phase(rng, dev)
        mark("K1 / K2 kernels")
        kernels.update(slide_kernel_phase(rng, dev))
        mark("K5 kernel")

        import skdownscale_tpu_torch as sdt

        X, Y, nan_cells = monthly_grid(rng)
        print(f"config 2: grid {N_TIME} months x {N_CELLS} cells float32, "
              f"{int(nan_cells.sum())} NaN cells")
        launches = run_grid("config 2", lambda: sdt.BcsdTemperature(return_anoms=False),
                            X, Y, nan_cells, N_REF_CELLS, 12, card, dev, rng,
                            ("count_sort_segments", "rank_map_segments"))
        streaming_phase(X, Y, nan_cells, card, dev)
        mark("config 2 and monthly streaming")
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
        config5_detrend_phase(X, Y, nan_cells, card, dev)
        mark("config 5 and config 5 detrend")
        del X, Y

        kernels.update(interp_kernel_phase(dev))
        mark("K6 kernel")
        X, Y, Xq, nan_cells = quantile_grid(rng, Q_CELLS, Q_SIDE, Q_FIT, Q_PRED)
        print(f"config 9b: fit {Q_FIT} days, predict {Q_PRED} days, {Q_CELLS} cells float32, "
              f"{int(nan_cells.sum())} NaN cells")
        q9b = run_registry_grid(
            "config 9b",
            lambda: sdt.TrendAwareQuantileMappingRegressor(
                sdt.QuantileMappingReressor(extrapolate="both")),
            X, Y, Xq, nan_cells, "predict", card, dev, rng, D_REF_CELLS,
        )
        _check(q9b.get("batched_interp", 0) >= 2,
               f"config 9b: K6 launched {q9b.get('batched_interp', 0)} times, not twice per predict")
        launches["batched_interp"] = q9b["batched_interp"]
        q9a = run_registry_grid("config 9a", lambda: sdt.QuantileMapper(detrend=True),
                                X, None, Xq, nan_cells, "transform", card, dev, rng, D_REF_CELLS)
        _check(q9a.get("rank_map_segments", 0) >= 1, f"config 9a: K2 was not launched: {q9a}")
        rows, L, err, ms, plain_ms, b_ms, b_by, sort_ms = k2_rows_time(Xq, nan_cells, dev)
        print(f"kernel rank_map_segments config 9a rows ({rows} x {L}, one segment a row): bitwise "
              f"equal to plain, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), torch.sort of the same rows {sort_ms:.4f} ms (sorts only, not the same "
              f"function); {describe_rank_map('rank_map_segments', L, build.build('rank_map').log)}; "
              f"card {card}")
        del X, Y, Xq
        long_rows_phase(rng, card, dev)
        mark("configs 9b, 9a and the 1950-2100 grid")
        config3_phase(rng, card, dev)
        mark("config 3")

        kernels.update(gard_kernel_phase(rng, dev))
        mark("K7 / K8 kernels")
        l4a, l4b = gard_phases(rng, card, dev)
        launches["pure_analog_stats"] = l4a["pure_analog_stats"]
        launches["analog_regression_stats"] = l4b["analog_regression_stats"]

        kernels.update(sort_kernel_phase(rng, dev))
        mark("configs 4a, 4b, PureRegression and the K9 kernel")
        l8 = mbcn_phase("config 8", rng, card, dev, None)
        for form in K9_FORMS:
            launches[form] = l8[form]
        mbcn_phase("config 8 monthly", rng, card, dev, "month")
        config8b_phase(rng, card, dev)
        mark("configs 8, 8 monthly and 8b")
        config7_phase(rng, card, dev)
        mark("config 7")
        config6_phase(rng, card, dev)
        mark("config 6 arrm and auto")
        fallback_phase(rng, card, dev)
        mark("the per-cell fallback")
        g_k6, _ = configG_phase(rng, card, dev)
        launches["batched_interp"] += g_k6
        mark("config G")
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
