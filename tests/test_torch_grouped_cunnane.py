"""The port's grouped Cunnane maps (``cunnane_transform_padded``,
``cunnane_inverse_padded`` in ``models/grouped.py``) against the JAX
package's on the CPU, in float64, on 3 cells x 4 years of daily data in the
``PaddedDOYGrouper`` layout (366 overlapping +-15-day groups; the record
ends on 31 October, so the groups of November and December hold fewer
members than the longest group and their rows are padded).  The port runs
K6's plain version (``kernels/interp.batched_interp_plain``); the JAX
package, on the CPU, its ``interp_ramp`` (every table here is shorter than
1,024 knots).

Tolerance: ``atol = 1e-10`` on values of order 1-300: the same float64
closed form, the tails' least squares summed in another order.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import skdownscale_tpu.models.grouped as JG
import skdownscale_tpu.utils.timeindex as JT

import skdownscale_tpu_torch.models.grouped as PG
import skdownscale_tpu_torch.utils.timeindex as PT

ATOL = 1e-10
CELLS = 3
# four years less November and December of the last: the groups of those
# days' windows hold 3 years' members and are padded to the others' 124
INDEX = pd.date_range("1990-01-01", "1993-10-31", freq="D")  # 1992 is a leap year


@pytest.fixture(autouse=True, scope="module")
def release_compiled_programs():
    """Drop the JAX programs this module compiles, before and after (the
    Tier-1 process holds every module's programs; see test_torch_mbc.py)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def case():
    """Groups, data and the fitted CDFs of both packages."""
    rng = np.random.default_rng(13)
    T = len(INDEX)
    doy = INDEX.dayofyear.to_numpy()
    seas = 10 * np.sin(2 * np.pi * doy / 365.25)
    y = 283 + seas + rng.normal(0, 2.0, (CELLS, T))
    x = 284.5 + seas + rng.normal(0, 2.6, (CELLS, T))  # wider: both tails
    jgroups = JT.padded_doy_groups(JT.TimeIndex.from_pandas(INDEX), 15)
    pgroups = PT.padded_doy_groups(PT.TimeIndex.from_pandas(INDEX), 15)
    npt.assert_array_equal(jgroups.indices, pgroups.indices)
    counts = pgroups.counts
    assert counts.min() < pgroups.max_len  # padded groups are covered

    jcdf = JG.cunnane_fit_padded(JG.gather_groups(jnp.asarray(y), jgroups, fill=0.0), jgroups)
    pcdf = PG.cunnane_fit_padded(PG.gather_groups(torch.from_numpy(y), pgroups, fill=0.0), pgroups)
    npt.assert_array_equal(np.asarray(jcdf.vals), pcdf.vals.numpy())
    xg = np.asarray(JG.gather_groups(jnp.asarray(x), jgroups, fill=0.0))
    return jgroups, pgroups, counts, jcdf, pcdf, xg


@pytest.mark.parametrize("extrapolate", [None, "min", "max", "both"])
def test_transform_and_inverse_match_jax(case, extrapolate):
    """values -> plotting positions -> values, every (cell, group, slot),
    pads included."""
    jgroups, pgroups, counts, jcdf, pcdf, xg = case
    valid = pgroups.mask.reshape(-1)

    want_pp = np.asarray(JG.cunnane_transform_padded(
        jcdf, jnp.asarray(xg), jgroups, counts, extrapolate=extrapolate))
    got_pp = PG.cunnane_transform_padded(
        pcdf, torch.from_numpy(xg.copy()), pgroups, counts, extrapolate=extrapolate).numpy()
    assert got_pp.shape == xg.shape
    npt.assert_allclose(got_pp, want_pp, rtol=0, atol=ATOL)

    want = np.asarray(JG.cunnane_inverse_padded(
        jcdf, jnp.asarray(want_pp), jgroups, counts, valid, extrapolate=extrapolate))
    got = PG.cunnane_inverse_padded(
        pcdf, torch.from_numpy(want_pp.copy()), pgroups, counts, valid, extrapolate=extrapolate).numpy()
    npt.assert_allclose(got, want, rtol=0, atol=ATOL)

    m = np.broadcast_to(valid, got.shape)
    assert np.isfinite(got[m]).all()
    if extrapolate is None:  # clamped ends: every pp on the group's knots
        assert (got_pp[m] > 0).all() and (got_pp[m] < 1).all()
    else:  # x is wider than y: some queries take a tail line
        assert (got_pp[m] < 0.4 / 124).any() or (got_pp[m] > 1 - 0.4 / 124).any()


def test_a_shorter_group_keeps_its_own_ends(case):
    """In a padded group the table ends at its last valid knot: a query past
    it clamps there (no tails) or follows the least-squares line of the
    group's own last 10 valid knots (``np.polyfit``), never a pad's +inf."""
    jgroups, pgroups, counts, jcdf, pcdf, _ = case
    g = int(np.argmin(counts))
    n, Lt = int(counts[g]), pgroups.max_len
    q = torch.full((CELLS, pgroups.n_groups * Lt), 0.5, dtype=torch.float64)
    q[:, g * Lt:(g + 1) * Lt] = 0.9999
    valid = pgroups.mask.reshape(-1)
    vals = pcdf.vals.reshape(CELLS, -1, Lt)[:, g, :n].numpy()
    clamped = PG.cunnane_inverse_padded(pcdf, q, pgroups, counts, valid, extrapolate=None)
    npt.assert_array_equal(clamped.reshape(CELLS, -1, Lt)[:, g, 0].numpy(), vals[:, -1])
    tails = PG.cunnane_inverse_padded(pcdf, q, pgroups, counts, valid, extrapolate="max")
    pp = (np.arange(1, n + 1) - 0.4) / (n + 0.2)
    line = [np.polyval(np.polyfit(pp[-10:], v[-10:], 1), 0.9999) for v in vals]
    npt.assert_allclose(tails.reshape(CELLS, -1, Lt)[:, g, 0].numpy(), line, rtol=0, atol=1e-9)
    want = np.asarray(JG.cunnane_inverse_padded(
        jcdf, jnp.asarray(q.numpy()), jgroups, counts, valid, extrapolate="max"))
    npt.assert_allclose(tails.numpy(), want, rtol=0, atol=ATOL)
