"""The analog selection of the CUDA kernels K7 and K8 (``csrc/knn.cu``),
modelled in numpy and held bitwise against the plain selection
(``ops/knn.py:select_smallest``, a stable sort: ``lax.top_k``'s order, the
lower index first on a tie).

The model follows the kernel step by step: the squared distances' float32
patterns by the direct form in feature order; a first digit of
:data:`BITS` bits (bits 30 and down: a distance is a non-negative float or
the canonical NaN, so bit 31 is 0) counted in one pass, which finds the bin
of the k-th item; one compaction pass that writes the rows of lower bins
(sure members) ascending and puts the rows of that bin on a candidate list
of at most :data:`CAP` (pattern, index) pairs; a rank for each candidate
by counting the candidates before it in (pattern, index) order, the first
``k - below`` of them taken.  When the bin holds more than :data:`CAP`
rows, further digit passes over the record narrow it first (the overflow
route); once every bit is fixed the bin's rows share one pattern and are
taken in index order.  Best and sample analogs take their rank-r member
from the candidates' ranks when r falls in the k-th bin, else by the same
selection over the ``below`` sure members.  No JAX program is compiled.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from skdownscale_tpu_torch.ops.knn import select_smallest, sq_dist_direct

# csrc/knn.cu: BITS and CAP
BITS, CAP = 11, 64


def _patterns(X, Q):
    """float32 squared distances (m, n) by the direct form in feature order,
    one operation at a time (no fused multiply-add), as uint32 patterns."""
    d = None
    for c in range(X.shape[1]):
        diff = Q[:, None, c] - X[None, :, c]
        sq = diff * diff
        d = sq if d is None else d + sq
    return d.view(np.uint32)


def _select(pat, idx, r, *, emit, bits=BITS, cap=CAP, tie="index", overflow=True):
    """The kernel's warp selection of the r-th (1-based) item, in (pattern,
    index) order, over the items ``pat`` / ``idx`` (ascending index).
    Returns (out, found, below, passes, first_count): with ``emit`` the
    indices of the r first items (lower bins ascending, then the r-th
    item's bin in order), the index of the r-th item, the count of the
    lower bins, the passes over the items and the first digit's bin count.

    ``tie="reversed"`` (the higher index first) and ``overflow=False`` (a
    full list drops what does not fit, no further digit pass) are broken
    variants that the tests require to fail."""
    prefix = mask = below = passes = 0
    remaining, shift, first_count = r, 31, None
    while True:
        width = min(shift, bits)
        shift -= width
        dmask = (1 << width) - 1
        in_bin = (pat & np.uint32(mask)) == prefix
        hist = np.bincount((pat[in_bin] >> np.uint32(shift)) & np.uint32(dmask), minlength=1 << width)
        passes += 1
        cum = np.cumsum(hist)
        digit = int(np.searchsorted(cum, remaining))  # the first bin reaching the rank
        before = int(cum[digit] - hist[digit])
        below, remaining, count = below + before, remaining - before, int(hist[digit])
        prefix |= digit << shift
        mask |= dmask << shift
        first_count = count if first_count is None else first_count
        if count <= cap or shift == 0 or not overflow:
            break
    passes += 1  # compaction
    in_bin = (pat & np.uint32(mask)) == prefix
    out = np.full(below + remaining, -1, np.int64)
    out[:below] = idx[pat < prefix]
    b_idx, b_pat = idx[in_bin], pat[in_bin]
    if count > cap and overflow:  # every bit fixed: one pattern, index order
        order = np.arange(count) if tie == "index" else np.arange(count)[::-1]
        rho = np.empty(count, np.int64)
        rho[order] = np.arange(count)
    else:
        b_idx, b_pat = b_idx[:cap], b_pat[:cap]  # a correct route never cuts here
        low = b_idx.astype(np.uint64) if tie == "index" else ~b_idx.astype(np.uint64) & np.uint64(0xFFFFFFFF)
        keys = (b_pat.astype(np.uint64) << np.uint64(32)) | low
        rho = np.argsort(np.argsort(keys, kind="stable"), kind="stable")
    take = rho < remaining
    out[below + rho[take]] = b_idx[take]
    found = int(b_idx[rho == remaining - 1][0]) if (rho == remaining - 1).any() else -1
    return (out if emit else None), found, below, passes, first_count


def _query(pat, k, r, **kw):
    """One query as the kernel runs it: the k members, the rank-r member
    (sub-selection over the sure members when r is below the k-th bin),
    the passes over the record and the first digit's bin count."""
    out, _, below, passes, count = _select(pat, np.arange(pat.size), k, emit=True, **kw)
    if r > below:
        jr = int(out[r - 1])
    else:
        members = out[:below]
        _, jr, _, _, _ = _select(pat[members], members, r, emit=False, **kw)
    return out, jr, passes, count, below


def _run(X, Q, k, rs, **kw):
    """Model and plain selection on one cell: (members, rank-r, passes,
    counts) of the model and the plain (m, k) indices and full order."""
    pat = _patterns(X, Q)
    d2 = sq_dist_direct(torch.from_numpy(X)[None], torch.from_numpy(Q)[None])[0]
    npt.assert_array_equal(d2.numpy().view(np.uint32), pat)  # the same bits as the plain version
    _, full = select_smallest(d2, X.shape[0])
    full = full.numpy()
    res = [_query(pat[i], k, int(rs[i]), **kw) for i in range(Q.shape[0])]
    return res, full, pat


def _check(res, full, pat, k, rs):
    """Members in (pattern, index) order equal the plain selection bitwise,
    the candidate tail in place, the sure members ascending, the rank-r
    member the plain one's; returns the passes."""
    passes = []
    for i, (out, jr, p, _, below) in enumerate(res):
        want = full[i, :k]
        assert out.size == k and (out >= 0).all()
        npt.assert_array_equal(out[np.lexsort((out, pat[i, out]))], want)
        npt.assert_array_equal(out[below:], want[below:])
        assert (np.diff(out[:below]) > 0).all()
        assert jr == full[i, int(rs[i]) - 1]
        passes.append(p)
    return np.array(passes)


def _gard(rng, n, m, f):
    """config 4's data (bench.py:1059-1064): X and queries ~ N(10, 3),
    centred on the training mean as the kernels take them."""
    X = rng.normal(10, 3, (n, f)).astype(np.float32)
    Q = rng.normal(10, 3, (m, f)).astype(np.float32)
    mu = X.mean(axis=0, dtype=np.float32)
    return X - mu, Q - mu


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_config4_data_two_passes_and_candidate_counts(rng):
    """config-4-like cells (n 3,650, f 2, k 200): every member set and
    rank-r member bitwise, two passes over the record a query (no overflow
    at :data:`CAP`); prints the first digit's bin count at 10 to 12 bits."""
    counts = {b: [] for b in (10, 11, 12)}
    for _ in range(3):
        X, Q = _gard(rng, 3650, 120, 2)
        rs = rng.integers(1, 201, Q.shape[0])
        res, full, pat = _run(X, Q, 200, rs)
        passes = _check(res, full, pat, 200, rs)
        assert (passes == 2).all()
        counts[BITS] += [r[3] for r in res]
        for b in counts:
            if b != BITS:
                counts[b] += [_select(p, np.arange(p.size), 200, emit=False, bits=b)[4] for p in pat]
    for b, c in counts.items():
        c = np.array(c)
        print(f"first digit {b} bits: candidates median {np.median(c):.0f}, p99 {np.quantile(c, 0.99):.0f}, "
              f"max {c.max()} of n = 3650 ({c.size} queries)")
    assert np.quantile(counts[BITS], 0.99) <= CAP


@pytest.mark.parametrize(
    "case,n,m,f,k",
    [
        ("duplicated", 1001, 40, 2, 200),
        ("on_train", 1001, 40, 2, 200),
        ("all_equal", 700, 12, 2, 300),
        ("k1", 333, 40, 3, 1),
        ("kn", 250, 20, 2, 250),
        ("ragged", 97, 30, 1, 50),
        ("long", 60_000, 3, 2, 300),
    ],
)
def test_model_matches_the_plain_selection_bitwise(rng, case, n, m, f, k):
    X, Q = _gard(rng, n, m, f)
    if case == "duplicated":
        X[n // 2 : 2 * (n // 2)] = X[: n // 2]  # exact distance ties
    if case == "on_train":
        X[n // 2 : 2 * (n // 2)] = X[: n // 2]
        Q = X[rng.integers(0, n, m)].copy()  # zero distances, tied
    if case == "all_equal":
        X[:] = X[0]  # one distance a query: every row in one bin, the overflow route
    rs = rng.integers(1, k + 1, m)
    res, full, pat = _run(X, Q, k, rs)
    passes = _check(res, full, pat, k, rs)
    overflow = np.array([r[3] > CAP for r in res])
    assert (passes[~overflow] == 2).all()
    if case == "all_equal":
        assert overflow.all() and (passes == 4).all()  # 11 + 11 + 9 bits, then compaction


def test_forced_overflow_by_a_small_capacity(rng):
    """CAP = 4 sends most config-4-like queries down the overflow route,
    which must still give the plain set and order."""
    X, Q = _gard(rng, 3650, 40, 2)
    rs = rng.integers(1, 201, 40)
    res, full, pat = _run(X, Q, 200, rs, cap=4)
    passes = _check(res, full, pat, 200, rs)
    assert (passes > 2).mean() > 0.5


@pytest.mark.parametrize(
    "broken,case",
    [({"tie": "reversed"}, "duplicated"), ({"tie": "reversed"}, "all_equal"), ({"overflow": False}, "all_equal"),
     ({"overflow": False, "cap": 4}, "gard")],
)
def test_broken_tie_rule_or_overflow_route_fails(rng, broken, case):
    """The model is sharp: the higher index first on a tie, or a full list
    that drops what does not fit, gives another set or order."""
    X, Q = _gard(rng, 1001, 30, 2)
    if case == "duplicated":
        X[500:1000] = X[:500]
        Q = X[rng.integers(0, 1001, 30)].copy()
    if case == "all_equal":
        X[:] = X[0]
    rs = rng.integers(1, 201, 30)
    with pytest.raises(AssertionError):
        res, full, pat = _run(X, Q, 200, rs, **broken)
        _check(res, full, pat, 200, rs)

