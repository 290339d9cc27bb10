"""The port's batched table interpolation (K6) and ``ops/interp.py``,
``ops/ranks.py`` against the JAX package on the CPU.

* The plain K6 against the JAX ``interp_rows`` in float64, on both sides of
  the JAX CPU route's switch at ``L = 1024`` (``interp_ramp`` at or below,
  ``interp_sortmerge`` above): NaN masks equal, values within
  ``rtol=1e-15, atol=1e-12`` (the same closed form, ulp-level slack for
  XLA's fusion of it; the +-1e20 sentinel tables carry values near 1e22).
* The plain K6 against the Pallas kernel ``batched_interp(...,
  interpret=True)`` in float32 at B = 256: within 1 ulp, NaN at the same
  places, each difference shown to be XLA's FMA contraction of the closed
  form (NaN payloads differ between the two routes and are not compared).
* NaN knots and ``+inf`` pads follow ``interp_ramp`` (pinned against it);
  the Pallas kernel departs from it on both, so it is compared on tables
  without them.

Inputs are made with numpy from a seed: ties in ``xp``, queries equal to
knots and beyond both ends, NaN and +-inf queries, ``+inf`` pads in
``pad_table`` form, the +-1e20 sentinels, and shared (one-row) tables.
"""

import importlib
from fractions import Fraction

import numpy as np
import numpy.testing as npt
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from skdownscale_tpu.ops.pallas.interp_kernel import batched_interp as pallas_interp
from skdownscale_tpu.ops.ranks import self_quantiles as j_self_quantiles

# the JAX package's ops/__init__.py exports a function named ``interp``,
# which shadows the module of that name as an attribute
ji = importlib.import_module("skdownscale_tpu.ops.interp")

pi = importlib.import_module("skdownscale_tpu_torch.ops.interp")  # the port's too
from skdownscale_tpu_torch.kernels import LAUNCHES
from skdownscale_tpu_torch.kernels import interp as I
from skdownscale_tpu_torch.kernels.interp import batched_interp, batched_interp_plain
from skdownscale_tpu_torch.ops.ranks import self_quantiles

RTOL, ATOL = 1e-15, 1e-12


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(rng, B, L, dtype=np.float64, pad=True, sentinels=False):
    """Monotone rows with ties; ragged rows padded per pad_table (+inf
    knots, the last valid fp); optional +-1e20 end knots with values by
    OLS-like extrapolation, as the quantile paths build them."""
    xp = np.sort(np.round(rng.normal(0, 5, (B, L)) * 2) / 2, axis=1)  # many ties
    fp = np.cumsum(rng.uniform(0, 1, (B, L)), axis=1)
    fp[:, 1::7] = fp[:, 0::7][:, : fp[:, 1::7].shape[1]]  # flat runs (ties in fp)
    fp = np.maximum.accumulate(fp, axis=1)
    if sentinels:
        xp[:, 0], xp[:, -1] = -1e20, 1e20
        fp[:, 0], fp[:, -1] = fp[:, 1] - 3e22, fp[:, -2] + 3e22
    if pad:
        n_valid = rng.integers(max(2, L // 2), L + 1, B)
        valid = np.arange(L)[None, :] < n_valid[:, None]
        xp = np.where(valid, xp, np.inf)
        last = np.take_along_axis(fp, (n_valid - 1)[:, None], axis=1)
        fp = np.where(valid, fp, last)
    return xp.astype(dtype), fp.astype(dtype)


def _queries(rng, xp, Q, dtype=np.float64):
    B, L = xp.shape
    fin = np.where(np.isfinite(xp), xp, np.nan)
    lo, hi = np.nanmin(fin, axis=1)[:, None], np.nanmax(fin, axis=1)[:, None]
    q = rng.uniform(lo - 3, hi + 3, (B, Q))
    hit = rng.random((B, Q)) < 0.2  # exact knot hits (ties included)
    cols = rng.integers(0, L, (B, Q))
    knots = np.take_along_axis(xp, cols, axis=1)
    q = np.where(hit & np.isfinite(knots), knots, q)
    q[:, 0], q[:, 1] = lo[:, 0] - 10, hi[:, 0] + 10  # beyond both ends
    q[::5, 2] = np.nan
    q[::7, 3] = np.inf
    q[::11, 4] = -np.inf
    q[::3, 5] = -0.0
    return q.astype(dtype)


def _same(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    npt.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


def _bitwise_non_nan(got, want):
    got, want = np.asarray(got), np.asarray(want)
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    npt.assert_array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))


# ----------------------------------------------------------------------
# plain K6 against the JAX CPU routes, float64
# ----------------------------------------------------------------------


@pytest.mark.parametrize("L", [42, 1024, 1462])
@pytest.mark.parametrize("sentinels", [False, True])
def test_plain_matches_jax_interp_rows(rng, L, sentinels):
    xp, fp = _tables(rng, 24, L, sentinels=sentinels)
    q = _queries(rng, xp, 40)
    want = np.asarray(ji.interp_rows(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(q)))
    got = batched_interp_plain(_t(xp), _t(fp), _t(q))
    assert got.dtype == torch.float64 and got.shape == (24, 40)
    _same(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors and counts nothing
    n0 = LAUNCHES["batched_interp"]
    npt.assert_array_equal(batched_interp(_t(xp), _t(fp), _t(q)).numpy(), got.numpy())
    assert LAUNCHES["batched_interp"] == n0


@pytest.mark.parametrize("L", [300, 1462])
@pytest.mark.parametrize("shared", ["xp", "fp", "q"])
def test_shared_rows_match_broadcast_tables(rng, L, shared):
    """A one-row argument (stride 0 in the kernel) equals the JAX result on
    the table broadcast to every row."""
    xp, fp = _tables(rng, 16, L, pad=False, sentinels=True)
    q = _queries(rng, xp, 33)
    args = {"xp": xp, "fp": fp, "q": q}
    args[shared] = args[shared][:1]
    full = {k: np.broadcast_to(v, (16, v.shape[1])) for k, v in args.items()}
    want = np.asarray(ji.interp_rows(*(jnp.asarray(full[k]) for k in ("xp", "fp", "q"))))
    got = batched_interp_plain(*(_t(args[k]) for k in ("xp", "fp", "q")))
    _same(got.numpy(), want)


def test_nan_knots_follow_interp_ramp(rng):
    """A row with a NaN in xp or fp gives NaN for every non-NaN query the end
    clamps do not catch: interp_ramp's reductions carry the NaN into every
    bracket (the Pallas kernel's min-update skips it instead)."""
    xp, fp = _tables(rng, 6, 30, pad=False)
    xp[1, 12] = np.nan
    fp[2, 5] = np.nan
    xp[3, 0] = np.nan  # NaN first knot: the low clamp never fires
    fp[4, -1] = np.nan
    q = _queries(rng, np.nan_to_num(xp), 25)
    want = np.asarray(
        jax.vmap(ji.interp_ramp)(jnp.asarray(q), jnp.asarray(xp), jnp.asarray(fp))
    )
    got = batched_interp_plain(_t(xp), _t(fp), _t(q)).numpy()
    _same(got, want)
    assert np.isnan(got[1:5]).sum() > np.isnan(got[[0, 5]]).sum()


# ----------------------------------------------------------------------
# plain K6 against the Pallas kernel in interpret mode, float32
# ----------------------------------------------------------------------


def _fma_f32(base, a, slope):
    """float32 ``base + a * slope`` with one rounding (an FMA), exactly: the
    float32 nearest the exact value, ties to even."""
    exact = Fraction(float(base)) + Fraction(float(a)) * Fraction(float(slope))
    mid = np.float32(float(exact))
    cands = [np.nextafter(mid, np.float32(-np.inf)), mid, np.nextafter(mid, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact), int(c.view(np.int32)) & 1))


def _closed_form_f32(xp, fp, q):
    """numpy float32 closed form on unpadded NaN-free tables, returned as
    ``(sep, base, a, slope)``: ``sep = base + a * slope`` rounded after the
    product (the plain version's order), and the operands, so that a caller
    can form the fused (FMA) result."""
    f32 = np.float32
    big = f32(np.finfo(np.float32).max / 8)
    L = xp.shape[1]
    c = (xp[:, None, :] <= q[:, :, None]).sum(-1)
    take = lambda t, i: np.take_along_axis(t, np.clip(i, 0, L - 1), axis=1)  # noqa: E731
    x0 = np.where(c > 0, take(xp, c - 1), -np.inf).astype(f32)
    f0 = np.where(c > 0, take(fp, c - 1), -np.inf).astype(f32)
    x1 = np.where(c < L, take(xp, c), np.inf).astype(f32)
    f1 = np.where(c < L, take(fp, c), np.inf).astype(f32)
    with np.errstate(all="ignore"):
        x0, x1, f1 = np.clip(x0, -big, big), np.clip(x1, -big, big), np.minimum(f1, big)
        dx = x1 - x0
        slope = np.where(dx != 0, (f1 - f0) / np.where(dx != 0, dx, f32(1)), f32(0)).astype(f32)
        right = (q - x0) > (x1 - q)
        a = np.where(right, q - x1, q - x0).astype(f32)
        base = np.where(right, f1, f0).astype(f32)
        sep = (base + a * slope).astype(f32)
    ends = (q < xp[:, :1]) | (q > xp[:, -1:]) | np.isnan(q)
    return np.where(ends, np.nan, sep), base, a, slope


@pytest.mark.parametrize("L,Q", [(42, 40), (200, 64)])
@pytest.mark.parametrize("sentinels", [False, True])
def test_plain_vs_pallas_interpret_float32(rng, L, Q, sentinels):
    """Tables without NaN knots and without +inf pads, where the Pallas
    kernel departs from interp_ramp: its min-update ``xl < x1`` never takes
    a +inf knot, so past a padded row's last valid knot it keeps ``f1 =
    +inf`` and extrapolates with slope ``(big - f0) / (big - x0)``, about 1,
    where interp_ramp (and the port) clamp to the last valid fp.

    Within 1 ulp, bitwise where the closed form rounds the same way: XLA's
    CPU code generation contracts ``f + a * slope`` of the interpreted
    kernel into an FMA (one rounding), while the plain version rounds the
    product first, as the CUDA kernel does.  Both are pinned: the plain
    version equals the separately rounded numpy closed form bitwise, and
    the Pallas kernel the fused one."""
    xp, fp = _tables(rng, 256, L, dtype=np.float32, pad=False, sentinels=sentinels)
    q = _queries(rng, xp, Q, dtype=np.float32)
    want = np.asarray(
        pallas_interp(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(q), interpret=True)
    )
    got = batched_interp_plain(_t(xp), _t(fp), _t(q)).numpy()
    assert got.dtype == np.float32
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    ulps = np.abs(got[ok].view(np.int32).astype(np.int64) - want[ok].view(np.int32))
    assert ulps.max() <= 1
    sep, base, a, slope = _closed_form_f32(xp, fp, q)
    inner = ~np.isnan(sep)
    _bitwise_non_nan(got[inner], sep[inner])
    _bitwise_non_nan(got[~inner & ok], want[~inner & ok])  # clamped ends: the knot values
    differ = np.argwhere(inner & (got != want))
    assert len(differ) < 0.05 * got.size
    for b, i in differ:
        fused = _fma_f32(base[b, i], a[b, i], slope[b, i])
        assert fused.view(np.int32) == want[b, i].view(np.int32), (b, i)


# ----------------------------------------------------------------------
# the ops layer
# ----------------------------------------------------------------------


def test_interp_rows_leading_dims_and_expanded_tables(rng):
    xp, fp = _tables(rng, 12, 50, pad=False)
    q = _queries(rng, xp, 9)
    xp3, fp3, q3 = xp.reshape(3, 4, 50), fp.reshape(3, 4, 50), q.reshape(3, 4, 9)
    want = np.asarray(ji.interp_rows(jnp.asarray(xp3), jnp.asarray(fp3), jnp.asarray(q3)))
    _same(pi.interp_rows(_t(xp3), _t(fp3), _t(q3)).numpy(), want)
    # a plotting-position vector expanded over cells goes to K6 as one row
    pp = np.linspace(0.01, 0.99, 50)
    want = np.asarray(ji.interp_rows(jnp.asarray(xp3), jnp.broadcast_to(jnp.asarray(pp), (3, 4, 50)), jnp.asarray(q3)))
    _same(pi.interp_rows(_t(xp3), _t(pp).expand(3, 4, 50), _t(q3)).numpy(), want)
    assert pi._as_rows(_t(pp).expand(3, 4, 50), (3, 4), 50).shape == (1, 50)


def test_interp_rows_multi_matches_jax(rng):
    xp, fp = _tables(rng, 8, 60, pad=False)
    fp2 = fp * 2.0 + 1.0
    q = _queries(rng, xp, 21)
    want = ji.interp_rows_multi(jnp.asarray(xp), [jnp.asarray(fp), jnp.asarray(fp2)], jnp.asarray(q))
    got = pi.interp_rows_multi(_t(xp), [_t(fp), _t(fp2)], _t(q))
    for g, w in zip(got, want):
        _same(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("left,right", [(None, None), (-np.inf, np.inf), (-5.0, 7.0)])
def test_interp_and_interp_padded_match_jax(rng, left, right):
    xp, fp = _tables(rng, 1, 40, pad=False)
    xp, fp = xp[0], fp[0]
    x = _queries(rng, xp[None], 64)[0].reshape(8, 8)
    want = np.asarray(ji.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp), left, right))
    _same(pi.interp(_t(x), _t(xp), _t(fp), left, right).numpy(), want)
    valid = np.arange(40) < 29
    jxp, jfp = ji.pad_table(jnp.asarray(xp), jnp.asarray(fp), jnp.asarray(valid))
    pxp, pfp = pi.pad_table(_t(xp), _t(fp), _t(valid))
    npt.assert_array_equal(pxp.numpy(), np.asarray(jxp))
    npt.assert_array_equal(pfp.numpy(), np.asarray(jfp))
    want = np.asarray(ji.interp_padded(jnp.asarray(x), jxp, jfp, 29, left, right))
    _same(pi.interp_padded(_t(x), pxp, pfp, 29, left, right).numpy(), want)
    # the padded table interpolates as its valid prefix (np.interp)
    ok = np.isfinite(x)
    npt.assert_allclose(
        pi.interp_padded(_t(x), pxp, pfp, 29).numpy()[ok], np.interp(x[ok], xp[:29], fp[:29]),
        rtol=1e-12, atol=1e-12,
    )


@pytest.mark.parametrize("pad", [False, True])
def test_interp_ramp_matches_jax(rng, pad):
    """``ops.interp_ramp``, the one-row form of K6's plain version, against
    the JAX package's ``interp_ramp`` on a table with ties, sentinels and
    (``pad``) a +inf-padded tail, queries of any shape."""
    xp, fp = _tables(rng, 1, 40, pad=pad)
    xp, fp = xp[0], fp[0]
    x = _queries(rng, xp[None], 64)[0].reshape(4, 16)
    want = np.asarray(ji.interp_ramp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = pi.interp_ramp(_t(x), _t(xp), _t(fp))
    assert got.shape == x.shape
    _same(got.numpy(), want)


@pytest.mark.parametrize("quantize", [False, True])
def test_self_quantiles_matches_jax(rng, quantize):
    x = rng.normal(0, 3, (5, 7, 90))
    if quantize:
        x = np.round(x)
    x[0, 0, 3] = np.nan
    pp = (np.arange(1, 91) - 0.4) / (90 + 0.2)
    want = np.asarray(j_self_quantiles(jnp.asarray(x), jnp.asarray(pp)))
    got = self_quantiles(_t(x), _t(pp)).numpy()
    npt.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# properties against np.interp (as tests/test_property_interp.py)
# ----------------------------------------------------------------------


@st.composite
def table_and_queries(draw):
    L = draw(st.integers(min_value=2, max_value=60))
    Q = draw(st.integers(min_value=1, max_value=40))
    seed = draw(st.integers(min_value=0, max_value=2**31 - 1))
    quantize = draw(st.booleans())  # force ties
    rng = np.random.default_rng(seed)
    xp = np.sort(rng.normal(0, 5, L))
    if quantize:
        xp = np.round(xp)
        xp.sort()
    fp = np.cumsum(rng.uniform(0, 1, L))  # monotone
    mode = draw(st.sampled_from(["inrange", "wide", "knots"]))
    if mode == "inrange":
        q = rng.uniform(xp[0], xp[-1], Q)
    elif mode == "wide":
        q = rng.normal(0, 12, Q)
    else:  # exact knot hits
        q = rng.choice(xp, Q)
    return xp, fp, q


@settings(max_examples=120, deadline=None)
@given(table_and_queries())
def test_plain_k6_matches_numpy(case):
    xp, fp, q = case
    got = batched_interp_plain(_t(xp[None]), _t(fp[None]), _t(q[None])).numpy()[0]
    npt.assert_allclose(got, np.interp(q, xp, fp), rtol=1e-9, atol=1e-9)


@settings(max_examples=80, deadline=None)
@given(st.integers(min_value=2, max_value=80), st.integers(0, 2**31 - 1), st.booleans())
def test_self_quantiles_matches_numpy(n, seed, quantize):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, n)
    if quantize:
        x = np.round(x)  # ties
    pp = (np.arange(1, n + 1) - 0.4) / (n + 0.2)
    got = self_quantiles(_t(x), _t(pp)).numpy()
    npt.assert_allclose(got, np.interp(x, np.sort(x), pp), rtol=1e-12)


# ----------------------------------------------------------------------
# the CUDA kernel's long-row route (csrc/interp.cu), modelled in numpy:
# its partition of the NaN scan and of the searches gives the plain bits
# ----------------------------------------------------------------------

SCAN_CHUNK, SCAN_THREADS, LONG_THREADS = 4096, 256, 128  # kScanChunk, kScanThreads, kLongThreads


def _finish_f32(xp, fp, q, has_nan):
    """``finish`` of csrc/interp.cu on one row in numpy float32: the bracket
    by ``upper_bound`` (a right-sided search), the clamps and the closed
    form evaluated from the nearer knot, each operation rounded alone."""
    f32 = np.float32
    L = xp.size
    big = f32(np.finfo(np.float32).max / 8)
    with np.errstate(all="ignore"):
        lo = np.searchsorted(xp, q, side="right")
        x0 = np.where(lo > 0, xp[np.maximum(lo - 1, 0)], -np.inf).astype(f32)
        f0 = np.where(lo > 0, fp[np.maximum(lo - 1, 0)], -np.inf).astype(f32)
        x1 = np.where(lo < L, xp[np.minimum(lo, L - 1)], np.inf).astype(f32)
        f1 = np.where(lo < L, fp[np.minimum(lo, L - 1)], np.inf).astype(f32)
        x0, x1, f1 = np.clip(x0, -big, big), np.clip(x1, -big, big), np.minimum(f1, big)
        dx = x1 - x0
        slope = np.where(dx != 0, (f1 - f0) / np.where(dx != 0, dx, f32(1)), f32(0)).astype(f32)
        from_left = q - x0
        res = np.where(from_left > x1 - q, f1 + (q - x1) * slope, f0 + from_left * slope)
    res = np.where(has_nan, f32(np.nan), res)
    res = np.where(q < xp[0], fp[0], res)
    res = np.where(q > xp[-1], fp[-1], res)
    return np.where(np.isnan(q), q, res).astype(f32)


def _scan_chunk(row, k0, n, offset):
    """The knots of one scan chunk, by the kernel's three parts: the head up
    to the 16-byte boundary (``offset``: the row's element offset within a
    16-byte line), the float4 middle, the tail."""
    head = min(n, (4 - (offset + k0) % 4) % 4)
    n4 = (n - head) // 4
    parts = [row[k0:k0 + head], row[k0 + head:k0 + head + 4 * n4], row[k0 + head + 4 * n4:k0 + n]]
    assert sum(p.size for p in parts) == n
    return parts


def _route_model(xp, fp, q):
    """K6 as its route partitions the work, in numpy float32: on the
    long-row route the NaN flag of a row (or of the shared tables) is the
    OR over the scan's chunks of every xp and fp row, and the search grid
    of (row, chunk of LONG_THREADS queries) blocks takes each query once;
    below LONG_ROW_MIN a block a row scans and searches its row.  Returns
    (out, how often each query was searched)."""
    B = max(t.shape[0] for t in (xp, fp, q))
    L, Q = xp.shape[1], q.shape[1]
    flags = np.zeros(B + 1, bool)
    if I.long_row(L):
        nx, nf = xp.shape[0], fp.shape[0]
        per_row = -(-L // SCAN_CHUNK)
        for c in range((nx + nf) * per_row):
            seg, k = divmod(c, per_row)
            t, r = (xp, seg) if seg < nx else (fp, seg - nx)
            n = min(SCAN_CHUNK, L - k * SCAN_CHUNK)
            nan = any(np.isnan(p).any() for p in _scan_chunk(t[r], k * SCAN_CHUNK, n, (r * L) % 4))
            flags[B if t.shape[0] == 1 else r] |= nan
        blocks = [(b, ch) for b in range(B) for ch in range(-(-Q // LONG_THREADS))]
        threads = LONG_THREADS
    else:
        for b in range(B):
            for t in (xp, fp):
                row = t[0 if t.shape[0] == 1 else b]
                flags[b] |= any(np.isnan(row[tid::SCAN_THREADS]).any() for tid in range(SCAN_THREADS))
        blocks = [(b, ch) for b in range(B) for ch in range(-(-Q // Q))]
        threads = Q
    out = np.full((B, Q), np.float32(-7.0))
    searched = np.zeros((B, Q), np.int64)
    for b, ch in blocks:
        i = ch * threads + np.arange(threads)
        i = i[i < Q]
        searched[b, i] += 1
        take = lambda t: t[0 if t.shape[0] == 1 else b]  # noqa: E731
        out[b, i] = _finish_f32(take(xp), take(fp), take(q)[i], flags[b] | flags[B])
    return out, searched


def _long_rows(rng, L, Q, shared_q):
    """Three rows of L sorted float32 knots and values: a NaN knot of xp in
    the row's last scan chunk, a NaN in fp only, and a clean row; queries
    inside, outside and at the knots, NaN and +-inf."""
    xp = np.sort(rng.normal(0, 5, (3, L)), axis=1).astype(np.float32)
    fp = np.sort(rng.uniform(0, 1, (3, L)), axis=1).astype(np.float32)
    xp[0, L - 2] = np.nan
    fp[1, L // 2] = np.nan
    q = rng.normal(0, 6, (1 if shared_q else 3, Q)).astype(np.float32)
    q[:, :40] = xp[2, rng.integers(0, L, 40)]  # knot hits
    q[:, 40:43] = [np.nan, np.inf, -np.inf]
    return xp, fp, q


@pytest.mark.parametrize("shared_q", [False, True])
@pytest.mark.parametrize("dL", [-1, 0, 1])
def test_long_row_route_model_matches_the_plain_version_bitwise(rng, dL, shared_q):
    """At LONG_ROW_MIN - 1 (a block a row), LONG_ROW_MIN and LONG_ROW_MIN +
    1 (the long-row route), rows with a NaN knot in xp's last chunk, a NaN
    in fp only and none: the routes' partition searches every query once
    and gives batched_interp_plain's bits."""
    L, Q = I.LONG_ROW_MIN + dL, 300
    assert I.long_row(L) == (dL >= 0)
    xp, fp, q = _long_rows(rng, L, Q, shared_q)
    got, searched = _route_model(xp, fp, q)
    npt.assert_array_equal(searched, 1)
    want = batched_interp_plain(_t(xp), _t(fp), _t(q)).numpy()
    npt.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for r in (0, 1):  # every query the end clamps do not catch gives NaN
        qr = q[r % q.shape[0]]
        inner = ~np.isnan(qr) & (qr >= xp[r, 0]) & (qr <= xp[r, -1])
        assert inner.sum() > Q // 2 and np.isnan(want[r, inner]).all()
    assert not np.isnan(want[2, ~np.isnan(q[-1])]).any()
    # a shared table (stride 0) is scanned once and flags every row
    got, _ = _route_model(xp[:1], fp[2:], q)
    want = batched_interp_plain(_t(xp[:1]), _t(fp[2:]), _t(q)).numpy()
    npt.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_long_row_takes_config_g_ladder_only():
    """The long-row route by length alone: config G's pooled ladder (one
    row of 239,206,400 knots) takes it; G's map (2,048 knots), config 9b's
    (1,462), config 8's (3,650) and the Cunnane maps' (620) do not."""
    assert I.long_row(239_206_400)
    for L in (2_048, 1_462, 3_650, 620):
        assert not I.long_row(L), L


@pytest.mark.parametrize("nan_knot", [False, True])
def test_plain_long_row_matches_jax_interp_ramp(rng, nan_knot):
    """The plain K6 on one row of 262,144 knots, Q = 64, against the JAX
    package's ``interp_ramp`` in float64 (``interp_rows`` would take
    ``jnp.interp`` there, which does not follow ``interp_ramp`` on NaN
    knots)."""
    L = 262_144
    xp = np.sort(rng.normal(0, 5, L))
    fp = np.cumsum(rng.uniform(0, 1, L))
    if nan_knot:
        xp[L - 3] = np.nan
    q = _queries(rng, np.nan_to_num(xp, nan=0.0)[None], 64)[0]
    want = np.asarray(ji.interp_ramp(jnp.asarray(q), jnp.asarray(xp), jnp.asarray(fp)))
    got = batched_interp_plain(_t(xp[None]), _t(fp[None]), _t(q[None])).numpy()[0]
    _same(got, want)
    if nan_knot:
        assert np.isnan(got[~np.isnan(q) & (q >= xp[0]) & (q <= xp[-1])]).all()
