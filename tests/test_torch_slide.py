"""The daily host tables and the port's sliding sorted window (K5) against
the JAX package.

Host tables (calendars, day-of-year and day-of-month groups, the slide plan
and its consulted groups) are held bitwise.  On the CPU the K5 wrapper runs
its plain PyTorch version; it is held bitwise against the Pallas kernel in
interpret mode (float32) at the positions the kernel defines, with +inf
beyond each window's count, and in float64 against per-window ``np.sort`` of
the order-isomorphic keys.  The hazards of the kernel's notes are inputs
here: ties and +-0 (H2), an entering bucket clustered inside a value gap
(H3), leap and ``noleap`` calendars and partial first and last windows (H4),
and all-NaN cells (H5).  The CUDA kernel itself is checked against the plain
version on the card, in ``test_torch_cuda.py``.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import skdownscale_tpu.models.slide as js
import skdownscale_tpu.utils.timeindex as jt
from skdownscale_tpu.ops.pallas.slide_sort_kernel import slide_sorted_windows as jax_slide

import skdownscale_tpu_torch.models.slide as ps
import skdownscale_tpu_torch.utils.timeindex as pt
from skdownscale_tpu_torch.kernels import LAUNCHES
from skdownscale_tpu_torch.kernels.slide_sort import (
    slide_sorted_windows,
    slide_sorted_windows_plain,
)
from skdownscale_tpu_torch.ops.keys import to_ordered_int


def _groups_equal(a, b):
    for f in ("indices", "mask", "counts", "keys", "labels"):
        ga, gb = getattr(a, f), getattr(b, f)
        assert (ga is None) == (gb is None), f
        if ga is not None:
            npt.assert_array_equal(ga, gb, err_msg=f)
            assert ga.dtype == gb.dtype, f


def _plans_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in ("consulted", "w0_idx", "add_idx", "rem_idx"):
        npt.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert (a.Lt, a.Lto) == (b.Lt, b.Lto)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


# (port TimeIndex, JAX TimeIndex) pairs: standard with leap years, the
# climate calendars, and a short record whose first and last windows are
# partial
_CALENDARS = {
    "standard_5y": lambda m: m.TimeIndex.from_pandas(
        pd.date_range("2000-01-01", periods=5 * 365 + 2, freq="D")
    ),
    "noleap_4y": lambda m: m.TimeIndex.range_daily(4 * 365, start_year=1990, calendar="noleap"),
    "all_leap_3y": lambda m: m.TimeIndex.range_daily(3 * 366, calendar="all_leap"),
    "360_day_4y": lambda m: m.TimeIndex.range_daily(4 * 360, calendar="360_day"),
    "standard_short": lambda m: m.TimeIndex.from_pandas(
        pd.date_range("2003-01-20", periods=400, freq="D")
    ),
}


@pytest.mark.parametrize("name", sorted(_CALENDARS))
def test_daily_host_tables_bitwise(name):
    a, b = _CALENDARS[name](pt), _CALENDARS[name](jt)
    for f in ("month", "day", "dayofyear", "year", "is_leap_year"):
        npt.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.max_dayofyear == b.max_dayofyear
    assert pt.TimeIndex.from_any(a) is a
    pfit, jfit = pt.padded_doy_groups(a, offset=15), jt.padded_doy_groups(b, offset=15)
    _groups_equal(pfit, jfit)
    assert pfit.max_len == jfit.max_len
    _groups_equal(pt.day_groups(a), jt.day_groups(b))
    _groups_equal(pt.month_groups(a), jt.month_groups(b))
    t2f = np.arange(31)
    pplan, jplan = ps.build_slide_plan(pfit, t2f), js.build_slide_plan(jfit, t2f)
    _plans_equal(pplan, jplan)
    _groups_equal(ps.consulted_groups(pfit, pplan), js.consulted_groups(jfit, jplan))


def test_slide_plan_none_cases_bitwise():
    a, b = _CALENDARS["standard_5y"](pt), _CALENDARS["standard_5y"](jt)
    pfit, jfit = pt.padded_doy_groups(a), jt.padded_doy_groups(b)
    # fewer than 2 consulted windows
    assert ps.build_slide_plan(pfit, np.zeros(4, np.int64)) is None
    assert js.build_slide_plan(jfit, np.zeros(4, np.int64)) is None
    # a bucket wider than max_bucket: disjoint month groups differ by whole groups
    pm, jm = pt.month_groups(a), jt.month_groups(b)
    assert ps.build_slide_plan(pm, np.arange(12)) is None
    assert js.build_slide_plan(jm, np.arange(12)) is None
    # a narrower max_bucket than the daily buckets need
    assert ps.build_slide_plan(pfit, np.arange(31), max_bucket=4) is None
    assert js.build_slide_plan(jfit, np.arange(31), max_bucket=4) is None
    # the member lists of overlapping groups
    members = [np.array([0, 3, 4]), np.array([4, 5]), np.array([], np.int64)]
    _groups_equal(
        pt.PaddedGroups.from_member_lists(members, np.arange(3)),
        jt.PaddedGroups.from_member_lists(members, np.arange(3)),
    )


def _daily_values(rng, ti, C):
    """C >= 6 float32 cells: normal, heavy ties with +-0, NaN/-NaN/+-inf
    scattered (no interior NaN in cells 0-2), all-NaN (H5), clustered
    inserts (H3), and a constant cell."""
    T = len(ti)
    doy = ti.dayofyear
    y = rng.normal(280, 10, (C, T)).astype(np.float32)
    y[1] = np.round(y[1] / 10)  # heavy ties
    y[1, ::5] = -0.0
    y[1, 1::7] = 0.0
    y[2, ::11] = np.inf
    y[2, 3::13] = -np.inf
    y[3] = np.nan
    # entering buckets land mid-gap between two tight value bands
    clustered = np.where(doy % 2 == 0, -100.0, 100.0) + rng.normal(0, 0.1, T)
    clustered[doy >= 17] = rng.normal(0, 0.5, int((doy >= 17).sum()))
    y[4] = clustered
    y[5] = 7.0
    y[0, ::97] = np.nan
    y[0, 50::89] = -np.nan
    return y


def _check_against_pallas(got, want, counts, S, Lto):
    got = got.reshape(got.shape[0], -1, Lto)
    want = want.reshape(want.shape[0], -1, Lto)
    for i in range(S):
        c = int(counts[i])
        npt.assert_array_equal(_bits(got[:, i, :c]), _bits(want[:, i, :c]), err_msg=f"window {i}")
        assert np.all(got[:, i, c:] == np.inf), f"window {i} pads"
    assert np.all(got[:, S:] == np.inf)


@pytest.mark.parametrize("name", ["standard_5y", "noleap_4y"])
def test_slide_plain_bitwise_vs_pallas(rng, name):
    ti = _CALENDARS[name](pt)
    fit = pt.padded_doy_groups(ti)
    plan = ps.build_slide_plan(fit, np.arange(31))
    jplan = js.build_slide_plan(jt.padded_doy_groups(_CALENDARS[name](jt)), np.arange(31))
    y = _daily_values(rng, ti, 6)
    S = len(plan.consulted)
    n_rows = S + 1  # one trailing all-+inf row, as the chunk grid pads
    before = dict(LAUNCHES)
    got = slide_sorted_windows(torch.from_numpy(y), plan, n_rows=n_rows).numpy()
    assert dict(LAUNCHES) == before  # a CPU tensor takes the plain version
    assert got.shape == (6, n_rows * plan.Lto) and got.dtype == np.float32
    want = np.asarray(jax_slide(jnp.asarray(y), jplan, n_rows=n_rows, interpret=True))
    _check_against_pallas(got, want, fit.counts[plan.consulted], S, plan.Lto)


@pytest.mark.parametrize("name", ["standard_5y", "noleap_4y", "standard_short"])
def test_slide_plain_float64_vs_np_sort_of_keys(rng, name):
    ti = _CALENDARS[name](pt)
    fit = pt.padded_doy_groups(ti)
    plan = ps.build_slide_plan(fit, np.arange(31))
    y = _daily_values(rng, ti, 6).astype(np.float64)
    y[0, 7] = np.nan  # an interior NaN: sorts before the pads (K5's rule)
    got = slide_sorted_windows_plain(torch.from_numpy(y), plan).numpy()
    got = got.reshape(6, len(plan.consulted), plan.Lto)
    keys = to_ordered_int(torch.from_numpy(y)).numpy()
    for i, g in enumerate(plan.consulted):
        c = int(fit.counts[g])
        order = np.argsort(keys[:, fit.indices[g, :c]], axis=-1, kind="stable")
        want = np.take_along_axis(y[:, fit.indices[g, :c]], order, axis=-1)
        npt.assert_array_equal(_bits(got[:, i, :c]), _bits(want), err_msg=f"window {i}")
        assert np.all(got[:, i, c:] == np.inf)
    holds = [i for i, g in enumerate(plan.consulted) if 7 in fit.indices[g, : fit.counts[g]]]
    assert holds
    for i in holds:  # the NaN is the window's last value, before its pads
        assert np.isnan(got[0, i, int(fit.counts[plan.consulted[i]]) - 1])


def test_slide_wrapper_checks_its_inputs():
    ti = _CALENDARS["standard_short"](pt)
    plan = ps.build_slide_plan(pt.padded_doy_groups(ti), np.arange(31))
    y = torch.zeros((2, len(ti)))
    with pytest.raises(ValueError, match="n_rows"):
        slide_sorted_windows(y, plan, n_rows=3)
    with pytest.raises(ValueError, match="time step"):
        slide_sorted_windows(y[:, :100], plan)
    with pytest.raises(TypeError):
        slide_sorted_windows(y.to(torch.float16), plan)
