"""The plain references against the program's CPU float64 path at small
sizes (two witnesses that share no code agree to rounding), and their
pieces against numpy."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import mbcn as ref_mbcn
from portbench.reference import quantile_mapper as ref_qm

TOL = 1e-10


def _daily(g, C, n, loc, amp, trend, sd):
    t = torch.arange(n, dtype=torch.float64)
    x = loc + amp * torch.sin(2 * np.pi * t / 365.25) + trend * t / n
    return (x + sd * torch.randn(C, n, generator=g, dtype=torch.float64)).float().double()


@pytest.mark.parametrize("n_fit,n", [(730, 730), (1461, 730), (500, 1461)])
def test_quantile_mapper_against_the_program(n_fit, n):
    import skdownscale_tpu_torch as sdt
    from skdownscale_tpu_torch.models import batched

    g = torch.Generator().manual_seed(n_fit + n)
    fit = _daily(g, 6, n_fit, 282.0, 10.0, 1.0, 1.8)
    x = _daily(g, 6, n, 283.5, 11.0, 1.5, 2.1)
    model = sdt.QuantileMapper(detrend=True)
    state = batched.batched_fit(model, None, fit[..., None], None)
    got = batched.batched_transform(model, state, None, x[..., None], None)
    assert (got - ref_qm.qm_detrend(fit, x)).abs().max().item() < TOL


@pytest.mark.parametrize("m,n,p", [(400, 400, 400), (400, 400, 433), (380, 400, 420)])
def test_mbcn_against_the_program(m, n, p):
    from skdownscale_tpu_torch.models import mbc

    g = torch.Generator().manual_seed(m + n + p)
    chol = torch.tensor(np.linalg.cholesky(0.6 * np.ones((3, 3)) + 0.4 * np.eye(3)).T)
    obs = torch.randn(4, m, 3, generator=g, dtype=torch.float64) @ chol
    hist = 1.4 * torch.randn(4, n, 3, generator=g, dtype=torch.float64) + 1.0
    fut = 1.4 * torch.randn(4, p, 3, generator=g, dtype=torch.float64) + 1.3
    rots = ref_mbcn.rotations(3, 8, 21)
    kinds = ("difference",) * 3
    pmh, pmf = mbc.mbcn_margins(obs, hist, fut, kinds=kinds)
    mh, mf = ref_mbcn.margins(obs, hist, fut)
    assert (pmh.reshape(-1, n) - mh).abs().max().item() < TOL
    assert (pmf.reshape(-1, p) - mf).abs().max().item() < TOL
    got = mbc.mbcn_correct(obs, hist, fut, rots, kinds=kinds)
    want = ref_mbcn.mbcn(obs, hist, fut, rots)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() < TOL


def test_rotations_are_the_programs_algorithm_and_orthogonal():
    from skdownscale_tpu_torch.models import mbc

    r = ref_mbcn.rotations(3, 20, 2**31 + 5)
    np.testing.assert_array_equal(r, mbc.mbcn_rotations(3, 20, 2**31 + 5))
    np.testing.assert_allclose(np.einsum("rij,rik->rjk", r, r), np.broadcast_to(np.eye(3), r.shape), atol=1e-12)


def test_interp_is_numpy_interp():
    rng = np.random.default_rng(4)
    xp = np.sort(np.round(rng.normal(0, 3, (5, 60)), 1), axis=1)  # ties
    fp = np.cumsum(rng.random((5, 60)), axis=1)
    q = np.concatenate([rng.normal(0, 4, (5, 40)), xp[:, ::7]], axis=1)  # knots too
    want = np.stack([np.interp(q[i], xp[i], fp[i]) for i in range(5)])
    got = ref_qm.interp(*(torch.from_numpy(a) for a in (q, xp, fp))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_interp_next_to_a_synthetic_knot():
    """Between a knot at -1e20 and the first real knot the exact line lies
    within a step of the real knot's value, where the far-knot form cancels."""
    xp = torch.tensor([[-1e20, 0.0119, 0.03]], dtype=torch.float64)
    fp = torch.tensor([[-3e19, -2.5, -2.0]], dtype=torch.float64)
    got = ref_qm.interp(torch.tensor([[0.0113]], dtype=torch.float64), xp, fp).item()
    assert abs(got - (-2.5 - 0.0006 * 3e19 / 1e20)) < 1e-9


def test_self_plotting_positions_take_the_last_tie():
    x = torch.tensor([[3.0, 1.0, 3.0, 2.0]], dtype=torch.float64)
    pp = ref_qm.plotting_positions(4, torch.float64, "cpu")
    np.testing.assert_array_equal(ref_qm.self_plotting_positions(x)[0].numpy(), pp[[3, 0, 3, 1]].numpy())


def test_tf32_rounding():
    a = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, 1.0 + 3 * 2**-12, -(1.0 + 3 * 2**-11)])
    np.testing.assert_array_equal(ref_mbcn.to_tf32(a).numpy(),
                                  np.array([1 + 2**-10, 1 + 2**-10, 1.0, 1 + 2**-10, -(1 + 2**-9)], np.float32))
