"""A numpy model of the CUDA sliding sorted window K5 (``csrc/slide_sort.cu``),
held bitwise against the port's plain version.

The model follows the kernel's warp step by step: the two buckets sorted by
the kernel's bitonic network of 32*K keys (K = 1, 2 or 4 a lane, key
``e = r*32 + lane``), each leaving key's place ``#{W <= r_k} - #{R <= r_k} +
k``, each lane's strip of the merged (window, entering) sequence found by
one merge-path search (window first on ties) and one count of the removed
places before it, and the walk along the strip.  Window 0 is sorted with
``np.sort``: the kernel sorts it with K9's radix sort, whose model is in
``tests/test_torch_sort.py``.  Inputs hold ties and +-0 (H2), entering
buckets clustered inside a value gap (H3), leap and ``noleap`` calendars
(H4), all-NaN cells (H5), interior NaN and the NaN whose key is the pad key,
and one plan with BW > 32 and Wp > 1,024 (50 years of daily data).  A
split search one place off its diagonal, or removed places counted from
the wrong index, must make the model disagree.  Numpy and torch only, no JAX program.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from skdownscale_tpu_torch.kernels.slide_sort import slide_sorted_windows_plain
from skdownscale_tpu_torch.models.slide import build_slide_plan
from skdownscale_tpu_torch.utils.timeindex import TimeIndex, padded_doy_groups

PAD = np.uint32(0xFFFFFFFF)  # the key of the int32 pad key INT32_MAX
LANES = 32


def _ukeys(x):
    """radix_sort.cuh's ordered_ukey of float32 values."""
    b = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    k = np.where(b >= 0, b, (~b) ^ np.int64(-(2**31)))
    return (k.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32) ^ np.uint32(0x80000000)


def _values(keys):
    """out_value: the pad key as +inf, any other key as its float."""
    k = (keys ^ np.uint32(0x80000000)).view(np.int32).astype(np.int64)
    b = np.where(k >= 0, k, ~(k ^ np.int64(-(2**31))))
    v = (b & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    return np.where(keys == PAD, np.float32(np.inf), v)


def _slots(BW):
    return 1 if BW <= 32 else 2 if BW <= 64 else 4


def _bitonic(v, K):
    """warp_bitonic: v[e], e = r*32 + lane, 32*K keys, ascending."""
    v = v.copy()
    n = LANES * K
    e = np.arange(n)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            lower = (e & j) == 0
            partner = e ^ j
            ascending = (e & k) == 0  # the same for both keys of a pair
            lo = np.minimum(v, v[partner])
            hi = np.maximum(v, v[partner])
            v = np.where(lower == ascending, lo, hi)
            j >>= 1
        k <<= 1
    return v


def _bucket(yk, idx, K):
    """A step's bucket as the lanes load it: 32*K keys, pads past the row."""
    v = np.full(LANES * K, PAD, np.uint32)
    m = idx >= 0
    v[: len(idx)][m] = yk[idx[m]]
    return v, int(m.sum())


def _ub(a, n, v):
    return int(np.searchsorted(a[:n], v, side="right"))


def _lb(a, n, v):
    return int(np.searchsorted(a[:n], v, side="left"))


def _step(W, n, R, nr, A, na, mutation=None):
    """One slide step of one warp: the new window (n - nr + na keys).  The
    32 lanes run side by side as numpy vectors; each lane's merge-path
    search and strip walk are the kernel's."""
    P = np.array([_ub(W, n, R[e]) - _ub(R, nr, R[e]) + e for e in range(nr)], np.int64)
    Wx = np.append(W[:n], PAD)  # W[i] for i <= n, as the kernel's guarded reads
    Ax = np.append(A[:na], PAD)
    Px = np.append(P, np.iinfo(np.int64).max)
    N = np.zeros(n - nr + na, np.uint32)
    M = n + na
    per = (M + LANES - 1) // LANES
    o0 = np.minimum(np.arange(LANES) * per, M)
    o1 = np.minimum(o0 + per, M)
    i, hi = np.maximum(0, o0 - na), np.minimum(o0, n)
    while np.any(i < hi):  # merge path, W first on ties
        on = i < hi
        mid = (i + hi) >> 1
        a_at = o0 - mid if mutation == "split" else o0 - 1 - mid  # the mutant is one off
        w_first = Wx[np.minimum(mid, n)] <= Ax[np.clip(a_at, 0, na)]
        i = np.where(on & w_first, mid + 1, i)
        hi = np.where(on & ~w_first, mid, hi)
    j = o0 - i
    kr = np.searchsorted(P, o0 if mutation == "removed" else i, side="left")
    dst = i - kr + j
    for t in range(per):
        on = o0 + t < o1
        wi, aj = Wx[np.minimum(i, n)], Ax[np.minimum(j, na)]
        take_w = on & (i < n) & ((j >= na) | (wi <= aj))
        leaves = take_w & (Px[kr] == i)
        put = on & ~leaves
        N[dst[put]] = np.where(take_w, wi, aj)[put]
        dst = dst + put
        kr = kr + leaves
        i = i + take_w
        j = j + (on & ~take_w)
    return N


def _model(y, plan, n_rows, mutation=None):
    """The kernel's output for one cell (T,) float32: (n_rows * Lto,)."""
    S, Lto, BW = len(plan.consulted), plan.Lto, plan.add_idx.shape[1]
    K = _slots(BW)
    yk = _ukeys(y)
    out = np.full((n_rows, Lto), np.inf, np.float32)
    w0 = plan.w0_idx[plan.w0_idx >= 0]
    W = np.sort(yk[w0])
    n = len(W)
    out[0, :n] = _values(W)
    for s in range(1, S):
        rem, nr = _bucket(yk, plan.rem_idx[s - 1], K)
        add, na = _bucket(yk, plan.add_idx[s - 1], K)
        R, A = _bitonic(rem, K), _bitonic(add, K)
        W = _step(W, n, R, nr, A, na, mutation)
        n = len(W)
        out[s, :n] = _values(W)
    return out.reshape(-1)


def _plan(years, start="1990-01-01", calendar=None, max_bucket=48):
    if calendar:
        ti = TimeIndex.range_daily(years * 365, start_year=1990, calendar=calendar)
    else:
        ti = TimeIndex.from_pandas(pd.date_range(start, periods=int(years * 365.25), freq="D"))
    return ti, build_slide_plan(padded_doy_groups(ti), np.arange(31), max_bucket=max_bucket)


def _cells(rng, ti):
    """Six float32 cells: heavy ties with +-0 (H2), NaN / -NaN / +-inf and the
    NaN 0x7fffffff, all-NaN (H5), an entering bucket clustered in a value
    gap (H3), a constant cell and a plain one."""
    T = len(ti)
    doy = ti.dayofyear
    y = rng.normal(280, 10, (6, T)).astype(np.float32)
    y[0] = np.round(y[0] / 10)
    y[0, ::5] = -0.0
    y[0, 1::7] = 0.0
    y[1, ::97] = np.nan
    y[1, 50::89] = -np.nan
    y[1, 3::61] = np.inf
    y[1, 7::67] = -np.inf
    y[1, 11::53] = np.frombuffer(np.uint32(0x7FFFFFFF).tobytes(), np.float32)[0]
    y[2] = np.nan
    clustered = np.where(doy % 2 == 0, -100.0, 100.0) + rng.normal(0, 0.1, T)
    clustered[doy >= 17] = rng.normal(0, 0.5, int((doy >= 17).sum()))
    y[3] = clustered
    y[4] = 7.0
    return y


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


_PLANS = {
    "20y": dict(years=20),
    "noleap_10y": dict(years=10, calendar="noleap"),
    "leap_start_6y": dict(years=6, start="1999-01-01"),
    "50y_bw56": dict(years=50, max_bucket=64),
}


@pytest.fixture
def rng():
    return np.random.default_rng(8)


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_slide_model_matches_the_plain_version_bitwise(rng, name):
    ti, plan = _plan(**_PLANS[name])
    y = _cells(rng, ti)
    n_rows = len(plan.consulted) + 2  # rows past the last window: +inf
    want = slide_sorted_windows_plain(torch.from_numpy(y), plan, n_rows=n_rows).numpy()
    for c in range(y.shape[0]):
        np.testing.assert_array_equal(_bits(_model(y[c], plan, n_rows)), _bits(want[c]), err_msg=f"cell {c}")


def test_the_50_year_plan_takes_two_slots_and_the_block_sort():
    _, plan = _plan(**_PLANS["50y_bw56"])
    assert plan.add_idx.shape[1] > 32 and len(plan.w0_idx) > 1024 and plan.Lto > 1024
    assert _slots(plan.add_idx.shape[1]) == 2


@pytest.mark.parametrize("K", [1, 2, 4])
def test_bucket_network_sorts_ties_and_pads(rng, K):
    for _ in range(20):
        v = _ukeys(np.round(rng.normal(0, 3, LANES * K)).astype(np.float32))
        v[rng.random(LANES * K) < 0.3] = PAD
        np.testing.assert_array_equal(_bitonic(v, K), np.sort(v))


@pytest.mark.parametrize("mutation", ["split", "removed"])
def test_a_broken_split_or_removal_count_disagrees(rng, mutation):
    """Mutants of the model: the split search comparing with the entering
    key one place off its diagonal, and the removed places counted before
    the strip's merged index instead of its window index.  Each must give
    another output on these inputs.  (Turning the split's tie rule alone
    changes nothing: tied keys are the same bits.)"""
    ti, plan = _plan(years=20)
    y = _cells(rng, ti)
    n_rows = len(plan.consulted)
    want = slide_sorted_windows_plain(torch.from_numpy(y), plan, n_rows=n_rows).numpy()
    wrong = 0
    for c in range(y.shape[0]):
        try:
            got = _model(y[c], plan, n_rows, mutation)
        except (IndexError, ValueError):  # a mutant may run off its buffers
            wrong += 1
            continue
        wrong += not np.array_equal(_bits(got), _bits(want[c]))
    assert wrong > 0
