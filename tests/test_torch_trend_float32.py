"""Float32 detrending against float64: the intercept first.

On the card the port detrends in float32.  A trendline evaluated there
rounds at the data's magnitude (half a spacing, about 1.5e-5 K at 283 K),
and subtracting it moves each detrended value by that much, enough to
reorder near-tied values against the CPU float64 path; a quantile map then
moves each such value by a step of its CDF.  ``(x - intercept) - slope * t``
subtracts the intercept exactly (it lies within a factor of two of the
data) and rounds only the small slope term.  Each test holds a float32
detrend to its float64 counterpart on the same float32 inputs and trend
within a bound that the trendline's own rounding breaks.  Numpy and torch
only, no JAX program.
"""

import numpy as np
import pytest
import torch

from skdownscale_tpu_torch.models import base, grouped
from skdownscale_tpu_torch.models.trend import LinearTrendTransformer, TrendState, trend_fit, trend_transform
from skdownscale_tpu_torch.utils.timeindex import PaddedGroups

# float32 spacing at the detrended values' magnitude (a few K) is about
# 5e-7 K; the trendline's rounding at 283 K is up to 1.5e-5 K
BOUND = 2e-6


@pytest.fixture
def series():
    rng = np.random.default_rng(7)
    t = np.arange(1_825)
    return (283.0 + 1e-3 * t + rng.normal(0.0, 2.0, (6, t.size))).astype(np.float32)


def _err(got32, want64):
    return float(np.abs(np.asarray(got32, np.float64) - np.asarray(want64)).max())


def test_trend_transform_in_float32_rounds_only_the_slope_term(series):
    st64 = trend_fit(torch.from_numpy(series.astype(np.float64)))
    st32 = TrendState(st64.slope.float(), st64.intercept.float())
    want = trend_transform(TrendState(st32.slope.double(), st32.intercept.double()),
                           torch.from_numpy(series).double())
    got = trend_transform(st32, torch.from_numpy(series))
    assert got.dtype == torch.float32
    assert _err(got, want) < BOUND


def test_linear_trend_transformer_in_float32_rounds_only_the_slope_term(series, monkeypatch):
    """The single-cell API with float32 cell tensors, as on the card."""
    monkeypatch.setattr(base.SingleCellEstimator, "single_cell_device", torch.device("cpu"))
    x = series.T  # (n, k)
    tr = LinearTrendTransformer().fit(x.astype(np.float64))
    # the state as a float32 fit leaves it, held in float64 for the reference
    tr._state = TrendState(*(a.astype(np.float32).astype(np.float64) for a in tr._state))
    want = tr.transform(x.astype(np.float64))
    monkeypatch.setattr(base.SingleCellEstimator, "_cell_tensor",
                        lambda self, a: torch.tensor(np.asarray(a), dtype=torch.float32))
    got = tr.transform(x)
    assert got.dtype == np.float32
    assert _err(got, want) < BOUND


def test_grouped_detrend_in_float32_rounds_only_the_slope_term(series):
    """The padded group rows of the grouped maps (``_detrend_flat``)."""
    G, L = 5, 365
    groups = PaddedGroups(indices=np.arange(G * L, dtype=np.int32).reshape(G, L),
                          mask=np.ones((G, L), bool), counts=np.full(G, L, np.int32), keys=np.arange(G))
    xg = torch.from_numpy(series[:, : G * L].copy())
    slope, intercept = grouped._masked_trend(xg.double(), groups)
    want = grouped._detrend_flat(xg.double(), slope.float().double(), intercept.float().double(), groups)
    got = grouped._detrend_flat(xg, slope.float(), intercept.float(), groups)
    assert got.dtype == torch.float32
    assert _err(got, want) < BOUND
