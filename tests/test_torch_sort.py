"""The port's row sort K9 (``kernels/sort_rows.py``) on the CPU: the plain
versions of its three forms against the Pallas kernel of
``skdownscale_tpu/ops/pallas/sort_kernel.py`` in interpret mode, at the
shapes and special rows of ``tests/test_sort_kernel.py``; the stable tie
order; the TPU kernel's pad-position fault (ROADMAP F8); numpy models of
the CUDA kernel's routes (the in-shared-memory radix sort; above
K9_MAX_LEN the shared-memory, cluster and device-memory routes and the
route rule; the unsort's index maps); and the BCSD row sort sites, which
route 256 < L to K9.

Values and unsorts are compared bitwise.  Positions are compared exactly
where a row has no tied keys; the Pallas kernel leaves the order of ties
unspecified, so in tied rows both must be permutations that gather the
sorted values.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

from skdownscale_tpu.ops.pallas import sort_kernel as JK

from skdownscale_tpu_torch.kernels import sort_rows as K

import _radix_model as R

SHAPES = [(16, 620), (130, 40), (8, 236), (5, 1024), (3, 7)]


def _specials(rng, B, L):
    """``tests/test_sort_kernel.py``'s rows: +-inf, NaN, heavy ties, an
    all-equal row."""
    x = rng.normal(0, 50, (B, L)).astype(np.float32)
    x[0, -5:] = np.inf
    x[1, : min(3, L)] = -np.inf
    x[2 % B, L // 2] = np.nan
    x[3 % B] = np.round(x[3 % B] / 50) * 50  # heavy ties
    x[4 % B, :] = 7.0  # all-equal row
    return x


def _keys(x):
    """numpy order-isomorphic keys (``ops/keys.py``) of a float32 array."""
    bits = x.view(np.int32)
    return np.where(bits >= 0, bits, np.invert(bits) ^ np.int32(-(2**31)))


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("B,L", SHAPES)
def test_sort_rows_plain_matches_pallas_bitwise(rng, B, L):
    x = _specials(rng, B, L)
    got = K.sort_rows_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(JK.sort_rows(jnp.asarray(x), interpret=True))
    npt.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("B,L", SHAPES)
def test_sort_rows_with_positions_plain_matches_pallas(rng, B, L):
    x = _specials(rng, B, L)
    sv, sp = K.sort_rows_with_positions_plain(torch.from_numpy(x))
    sv, sp = sv.numpy(), sp.numpy()
    jv, jp = (np.asarray(a) for a in JK.sort_rows_with_positions(jnp.asarray(x), interpret=True))
    assert sp.dtype == np.int32
    npt.assert_array_equal(_bits(sv), _bits(jv))
    keys = _keys(x)
    for b in range(B):
        if np.unique(keys[b]).size == L:  # no ties: one order
            npt.assert_array_equal(sp[b], jp[b])
        for p in (sp[b], jp[b]):
            npt.assert_array_equal(np.sort(p), np.arange(L))
            npt.assert_array_equal(_bits(x[b, p]), _bits(sv[b]))
    # the port's order is the stable one
    npt.assert_array_equal(sp, np.argsort(keys, axis=1, kind="stable"))


@pytest.mark.parametrize("B,L", SHAPES)
def test_unsort_rows_plain_round_trip_matches_pallas(rng, B, L):
    x = _specials(rng, B, L)
    sv, sp = K.sort_rows_with_positions_plain(torch.from_numpy(x))
    back = K.unsort_rows_plain(sv, sp).numpy()
    npt.assert_array_equal(_bits(back), _bits(x))
    want = np.asarray(JK.unsort_rows(jnp.asarray(sv.numpy()), jnp.asarray(sp.numpy()), interpret=True))
    npt.assert_array_equal(_bits(back), _bits(want))


def test_signed_zero_and_nan_payloads_follow_the_kernel_order(rng):
    """-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN, bitwise, as the
    Pallas kernel (JAX's CPU lax.sort treats -0 as +0 and puts every NaN
    last; the port follows the kernel)."""
    x = rng.normal(0, 5, (4, 24)).astype(np.float32)
    x[0, :2] = [-0.0, 0.0]
    x[1, :3] = [np.inf, -np.inf, np.nan]
    x.view(np.uint32)[2, 0] = 0x7FC00001
    x.view(np.uint32)[2, 1] = 0xFFC00000
    x.view(np.uint32)[3, 2] = 0x7FFFFFFF
    got = K.sort_rows_plain(torch.from_numpy(x)).numpy()
    npt.assert_array_equal(_bits(got), _bits(np.asarray(JK.sort_rows(jnp.asarray(x), interpret=True))))
    npt.assert_array_equal(_bits(got), _bits(np.take_along_axis(x, np.argsort(_keys(x), axis=1), 1)))


def test_float64_rows(rng):
    x = rng.normal(0, 3, (6, 301))
    x[2] = np.round(x[2]) + 0.25  # ties, no signed zeros (numpy takes -0 == +0)
    sv, sp = K.sort_rows_with_positions_plain(torch.from_numpy(x))
    npt.assert_array_equal(sv.numpy(), np.sort(x, axis=1))
    npt.assert_array_equal(sp.numpy(), np.argsort(x, axis=1, kind="stable"))
    npt.assert_array_equal(K.sort_rows_plain(torch.from_numpy(x)).numpy(), np.sort(x, axis=1))
    npt.assert_array_equal(K.unsort_rows_plain(sv, sp).numpy(), x)


def test_wrappers_take_the_plain_version_on_the_cpu(rng):
    x = torch.from_numpy(_specials(rng, 9, 50))
    n0 = dict(K.LAUNCHES)
    assert torch.equal(K.sort_rows(x).view(torch.int32), K.sort_rows_plain(x).view(torch.int32))
    sv, sp = K.sort_rows_with_positions(x)
    pv, pp = K.sort_rows_with_positions_plain(x)
    assert torch.equal(sv.view(torch.int32), pv.view(torch.int32)) and torch.equal(sp, pp)
    assert torch.equal(K.unsort_rows(sv, sp).view(torch.int32), x.view(torch.int32))
    assert dict(K.LAUNCHES) == n0  # the plain versions count no launch
    with pytest.raises(ValueError):
        K.sort_rows(x[0])  # not (B, L)
    with pytest.raises(ValueError):
        K.unsort_rows(sv, sp[:, :10])


def test_f8_pallas_k9_returns_pad_positions_the_port_does_not(rng):
    """ROADMAP F8: a row holding the NaN whose key is INT32_MAX (bits
    0x7fffffff), at a length that is not a power of two, ties with the
    Pallas kernel's pads, and its unstable network can return a pad
    position >= L.  The port's positions are a permutation of 0..L-1 that
    gathers the sorted values."""
    B, L = 16, 37
    x = rng.normal(0, 5, (B, L)).astype(np.float32)
    u = x.view(np.uint32)
    for b in range(B):
        u[b, rng.integers(0, L, 1 + b % 4)] = 0x7FFFFFFF
    _, jp = JK.sort_rows_with_positions(jnp.asarray(x), interpret=True)
    assert (np.asarray(jp) >= L).any()
    sv, sp = K.sort_rows_with_positions_plain(torch.from_numpy(x))
    sv, sp = sv.numpy(), sp.numpy()
    for b in range(B):
        npt.assert_array_equal(np.sort(sp[b]), np.arange(L))
        npt.assert_array_equal(_bits(x[b, sp[b]]), _bits(sv[b]))


# ----------------------------------------------------------------------
# the CUDA kernel's design (csrc/sort_rows.cu), modelled in numpy: a
# stable LSD radix sort gives the plain version's values and positions
# ----------------------------------------------------------------------


def _warps_and_items(L):
    """(warps a row, items a lane) as the launcher of csrc/sort_rows.cu
    picks them: a warp a row up to 1,024, else a block of at least 8 warps
    with contiguous chunks of 4, 12 or 16 items a lane."""
    if L <= 1024:
        return 1, 4 * -(-L // 128)
    items = 4 if L <= 2048 else 12 if L <= 4096 else 16
    return max(8, -(-L // (32 * items))), items


def _radix_model(x):
    """(sorted values, int32 positions) of float32 rows ``x`` as the kernel
    computes them: 32-bit keys ``ordered_ukey`` (the order-isomorphic key
    with its sign bit flipped), four 8-bit LSD passes, positions carried
    as uint16.  In each pass every warp ranks its items in warp-striped
    (i, l) order (item i of lane l is element i*32 + l of the warp's chunk):
    the running count of the item's digit in the warp's counters plus its
    peers on lower lanes; an exclusive scan of the counts in (digit, warp)
    order gives each warp its base per digit.  A pass whose byte is the
    same in every key of the row is skipped."""
    B, L = x.shape
    n_warps, items = _warps_and_items(L)
    chunk = 32 * items
    ukeys = _keys(x).view(np.uint32) ^ np.uint32(0x80000000)
    positions = np.tile(np.arange(L, dtype=np.uint16), (B, 1))
    lanes = np.arange(32)
    for b in range(B):
        key, pos = ukeys[b], positions[b]
        varying = int(np.bitwise_and.reduce(key) ^ np.bitwise_or.reduce(key))
        for shift in (0, 8, 16, 24):
            if not (varying >> shift) & 0xFF:
                continue
            digit = ((key >> shift) & 0xFF).astype(np.int64)
            counts = np.zeros((n_warps, 256), np.int64)
            local = np.empty(L, np.int64)
            for w in range(n_warps):
                for i in range(items):
                    e = w * chunk + i * 32 + lanes
                    e = e[e < L]
                    if e.size == 0:
                        break
                    d = digit[e]
                    peers = d[:, None] == d[None, :]
                    local[e] = counts[w, d] + np.tril(peers, -1).sum(1)
                    np.add.at(counts[w], d, 1)
            flat = counts.T.ravel()  # (digit, warp) order
            base = (np.cumsum(flat) - flat).reshape(256, n_warps).T
            rank = base[np.arange(L) // chunk, digit] + local
            npt.assert_array_equal(np.sort(rank), np.arange(L))
            key[rank], pos[rank] = key.copy(), pos.copy()
    ordered = (ukeys ^ np.uint32(0x80000000)).view(np.int32)
    bits = np.where(ordered >= 0, ordered, np.invert(ordered ^ np.int32(-(2**31))))
    return bits.view(np.float32), positions.astype(np.int32)


def _nan_zero_rows(rng, B, L):
    """Rows holding the NaN 0x7fffffff (INT32_MAX's key), other NaN
    payloads, -NaN, +-0 and +-inf."""
    x = rng.normal(0, 5, (B, L)).astype(np.float32)
    flat = x.view(np.uint32).reshape(-1)
    for bits in (0x7FFFFFFF, 0x7FC00000, 0xFFC00000, 0xFFFFFFFF, 0x0, 0x80000000, 0x7F800000,
                 0xFF800000):
        flat[rng.integers(0, flat.size, max(1, flat.size // 40))] = bits
    return x


@pytest.mark.parametrize("kind", ["specials", "nan_zero"])
@pytest.mark.parametrize("L", [1, 31, 32, 33, 620, 1025, 8192])
def test_radix_model_matches_the_plain_stable_sort_bitwise(rng, L, kind):
    B = 6 if L < 8192 else 3
    x = _specials(rng, B, L) if kind == "specials" else _nan_zero_rows(rng, B, L)
    vals, pos = _radix_model(x)
    want_v, want_p = K.sort_rows_with_positions_plain(torch.from_numpy(x))
    npt.assert_array_equal(_bits(vals), _bits(want_v.numpy()))
    npt.assert_array_equal(pos, want_p.numpy())
    npt.assert_array_equal(_bits(vals), _bits(K.sort_rows_plain(torch.from_numpy(x)).numpy()))


# the long route (L > K9_MAX_LEN): a block a row, 8 warps of 16 items a
# lane, tiles of 4,096 taken in order (kLongWarps, kLongItems of
# csrc/sort_rows.cu)
LONG_WARPS, LONG_ITEMS = 8, 16


def _long_radix_model(x):
    """(sorted values, int32 positions) of float32 rows ``x`` longer than
    ``K9_MAX_LEN`` as the long route computes them.  One sweep counts all
    four digits and the AND / OR of the keys; each pass's exclusive scan of
    its counts starts its running offsets.  Each pass that is not skipped
    takes the row's tiles in order: the tile's warps rank their items in
    (i, l) order, an exclusive scan in (digit, warp) order orders the tile
    by digit, and each digit's run goes to the row at the pass's running
    offset, which then advances by the tile's count.  Keys and 32-bit
    positions pass between the workspace and the outputs in turns, the
    last pass writing the outputs."""
    B, L = x.shape
    chunk = 32 * LONG_ITEMS
    tile = LONG_WARPS * chunk
    ukeys = _keys(x).view(np.uint32) ^ np.uint32(0x80000000)
    out_k = np.empty_like(ukeys)
    out_p = np.empty((B, L), np.int32)
    for b in range(B):
        key = ukeys[b]
        shifts = (0, 8, 16, 24)
        hist = [np.bincount((key >> s) & 0xFF, minlength=256) for s in shifts]  # the sweep
        running = [np.cumsum(h) - h for h in hist]
        varying = int(np.bitwise_and.reduce(key) ^ np.bitwise_or.reduce(key))
        active = [p for p, s in enumerate(shifts) if (varying >> s) & 0xFF]
        bufs = {"out": (np.empty(L, np.uint32), np.empty(L, np.int32)),
                "work": (np.empty(L, np.uint32), np.empty(L, np.int32))}
        src_k, src_p = key, np.arange(L, dtype=np.int32)
        for i, p in enumerate(active):
            dst = "out" if (len(active) - 1 - i) % 2 == 0 else "work"
            dst_k, dst_p = bufs[dst]
            assert dst_k is not src_k  # a pass never writes what it reads
            run = running[p].copy()
            for t0 in range(0, L, tile):
                tk, tp = src_k[t0:t0 + tile], src_p[t0:t0 + tile]
                n = tk.size
                d = ((tk >> shifts[p]) & 0xFF).astype(np.int64)
                n_warps = -(-n // chunk)
                counts = np.zeros((LONG_WARPS, 256), np.int64)
                local = np.empty(n, np.int64)
                for w in range(n_warps):  # (i, l) order is element order in the chunk
                    dw = d[w * chunk:(w + 1) * chunk]
                    order = np.argsort(dw, kind="stable")
                    first = np.searchsorted(dw[order], dw[order], side="left")
                    local[w * chunk + order] = np.arange(dw.size) - first
                    counts[w] = np.bincount(dw, minlength=256)
                flat = counts.T.ravel()  # (digit, warp) order
                base = (np.cumsum(flat) - flat).reshape(256, LONG_WARPS).T
                sorted_idx = base[np.arange(n) // chunk, d] + local  # the tile ordered by digit
                npt.assert_array_equal(np.sort(sorted_idx), np.arange(n))
                total = counts.sum(0)
                start = np.cumsum(total) - total
                r = run[d] + sorted_idx - start[d]  # gofs[d] + tile-sorted index
                dst_k[r], dst_p[r] = tk, tp
                run += total
            npt.assert_array_equal(run, running[p] + hist[p])
            src_k, src_p = dst_k, dst_p
        assert not active or src_k is bufs["out"][0]
        out_k[b], out_p[b] = src_k, src_p
    ordered = (out_k ^ np.uint32(0x80000000)).view(np.int32)
    bits = np.where(ordered >= 0, ordered, np.invert(ordered ^ np.int32(-(2**31))))
    return bits.view(np.float32), out_p


@pytest.mark.parametrize("kind", ["specials", "nan_zero"])
@pytest.mark.parametrize("L", [8193, 10957, 20000])
def test_long_radix_model_matches_the_plain_stable_sort_bitwise(rng, L, kind):
    """The long route's tile-ordered stable LSD passes with 32-bit positions
    and the constant-digit skip, at one past K9_MAX_LEN, a 30-year daily
    record and 20,000, give the stable sort's values and positions."""
    x = _specials(rng, 3, L) if kind == "specials" else _nan_zero_rows(rng, 3, L)
    x[-1] = np.float32(283.5) + rng.normal(0, 1, L).astype(np.float32)  # a constant top byte
    vals, pos = _long_radix_model(x)
    want_v, want_p = K.sort_rows_with_positions_plain(torch.from_numpy(x))
    npt.assert_array_equal(_bits(vals), _bits(want_v.numpy()))
    npt.assert_array_equal(pos, want_p.numpy())
    npt.assert_array_equal(_bits(vals), _bits(K.sort_rows_plain(torch.from_numpy(x)).numpy()))


def _tile_walk(src_k, src_p, dst_k, dst_p, run, shift, warps, items, e0, written):
    """One block's walk of one pass over its elements ``src_k`` (and 16-bit
    positions ``src_p``, None on the first pass: the elements' own, e0 +
    index): tiles of ``warps * items * 32`` in order; in a tile each warp
    ranks its contiguous chunk of ``items * 32`` in (i, l) order, which is
    element order, by digit; thread d turns the warps' counts of digit d
    into their places from the running place ``run[d]`` in (digit, warp)
    order, and ``run`` advances by the tile's counts.  Each item goes to
    its place in the row's buffers ``dst_k`` / ``dst_p``."""
    chunk = items * 32
    tile = warps * chunk
    for t0 in range(0, src_k.size, tile):
        tk = src_k[t0:t0 + tile]
        tn = tk.size
        tp = (e0 + t0 + np.arange(tn)).astype(np.uint16) if src_p is None else src_p[t0:t0 + tile]
        d = ((tk >> shift) & 0xFF).astype(np.int64)
        w = np.arange(tn) // chunk
        grp = w * 256 + d
        order = np.argsort(grp, kind="stable")
        local = np.empty(tn, np.int64)
        local[order] = np.arange(tn) - np.searchsorted(grp[order], grp[order], side="left")
        counts = np.bincount(grp, minlength=warps * 256).reshape(warps, 256)
        place = run[None, :] + np.cumsum(counts, 0) - counts  # (warp, digit)
        r = place[w, d] + local
        dst_k[r], dst_p[r] = tk, tp
        np.add.at(written, r, 1)
        run += counts.sum(0)


def _in_smem_radix_model(x, with_positions):
    """(sorted values, int32 positions) of float32 rows ``x`` as the
    shared-memory route (one block a row) or the cluster route (c blocks a
    row, ``K.cluster_size``) computes them, by ``K.sort_route``.  One block:
    the load's sweep counts all four digits, whose exclusive scans start
    each pass's running places (a row of one tile counts in its tile: the
    same counts).  A cluster: block r holds elements [r * m, r * m + m) of
    the current order, m = ceil(L / c) <= one tile; each pass every block
    counts its tile's digits, and its running place of digit d starts at
    the items of smaller digits in the row plus those of digit d in the
    blocks before it ((digit, block) order).  Either way a pass whose byte
    is the same in every key is skipped, each pass writes every place of
    the row once (in the block that holds it), and keys and 16-bit
    positions go from one buffer to the other."""
    B, L = x.shape
    route = K.sort_route(L, with_positions)
    assert route in ("smem", "cluster")
    c = 1 if route == "smem" else K.cluster_size(L)
    assert 2 <= c <= K.CLUSTER_MAX or route == "smem"
    warps, items = ((K.SMEM_WARPS, K.SMEM_ITEMS) if route == "smem"
                    else (K.CLUSTER_WARPS, K.CLUSTER_ITEMS))
    m = -(-L // c)
    assert K.row_smem_bytes(m, warps, with_positions) <= K.SMEM_LIMIT
    assert route == "smem" or m <= K.CLUSTER_TILE  # a cluster block walks one tile
    bounds = [(r * m, min(L, r * m + m)) for r in range(c)]
    assert all(lo < hi for lo, hi in bounds)
    ukeys = _keys(x).view(np.uint32) ^ np.uint32(0x80000000)
    out_k = np.empty_like(ukeys)
    out_p = np.empty((B, L), np.int32)
    shifts = (0, 8, 16, 24)
    for b in range(B):
        key, pos = ukeys[b].copy(), None
        varying = int(np.bitwise_and.reduce(key) ^ np.bitwise_or.reduce(key))
        hist = [np.bincount((key >> s) & 0xFF, minlength=256) for s in shifts]  # the one block's sweep
        for p, s in enumerate(shifts):
            if not (varying >> s) & 0xFF:
                continue
            dst_k, dst_p = np.empty(L, np.uint32), np.empty(L, np.uint16)
            written = np.zeros(L, np.int64)
            if c == 1:
                starts = [np.cumsum(hist[p]) - hist[p]]
            else:
                counts = np.stack([np.bincount((key[lo:hi] >> s) & 0xFF, minlength=256) for lo, hi in bounds])
                total = counts.sum(0)
                starts = (np.cumsum(total) - total)[None, :] + np.cumsum(counts, 0) - counts
            for r, (lo, hi) in enumerate(bounds):
                run = starts[r].copy()
                _tile_walk(key[lo:hi], None if pos is None else pos[lo:hi], dst_k, dst_p, run, s,
                           warps, items, lo, written)
            npt.assert_array_equal(written, 1)  # every place of the row once
            key, pos = dst_k, dst_p
        out_k[b] = key
        out_p[b] = np.arange(L) if pos is None else pos
    ordered = (out_k ^ np.uint32(0x80000000)).view(np.int32)
    bits = np.where(ordered >= 0, ordered, np.invert(ordered ^ np.int32(-(2**31))))
    return bits.view(np.float32), out_p


_SMEM_EDGES = [8193, 10957, K.K9_SMEM_MAX[False], K.K9_SMEM_MAX[False] + 1, K.K9_SMEM_MAX[True],
               K.K9_SMEM_MAX[True] + 1, 23741, 55152, K.CLUSTER_MAX * K.CLUSTER_TILE,
               K.CLUSTER_MAX * K.CLUSTER_TILE + 1, 65536, 65537]


@pytest.mark.parametrize("kind", ["specials", "nan_zero"])
@pytest.mark.parametrize("with_positions", [False, True], ids=["sort", "positions"])
@pytest.mark.parametrize("L", _SMEM_EDGES)
def test_in_smem_radix_models_match_the_plain_stable_sort_bitwise(rng, L, with_positions, kind):
    """The shared-memory route (a block a row) and the cluster route (2 to
    4 blocks a row, distributed shared memory) with 16-bit positions, the
    constant-digit skip and their tile walks, at each side of each form's
    K9_SMEM_MAX, one past K9_MAX_LEN, 30 years of days, 1950-2014 and
    1950-2100 daily and the longest cluster row, give the stable sort's
    values and positions; one past it, 65,536 and 65,537 take the
    device-memory route (its model)."""
    x = _specials(rng, 2, L) if kind == "specials" else _nan_zero_rows(rng, 2, L)
    x[-1] = np.float32(283.5) + rng.normal(0, 1, L).astype(np.float32)  # a constant top byte
    route = K.sort_route(L, with_positions)
    vals, pos = (_in_smem_radix_model(x, with_positions) if route != "device" else _long_radix_model(x))
    want_v, want_p = K.sort_rows_with_positions_plain(torch.from_numpy(x))
    npt.assert_array_equal(_bits(vals), _bits(want_v.numpy()))
    if with_positions:
        npt.assert_array_equal(pos, want_p.numpy())
    npt.assert_array_equal(_bits(vals), _bits(K.sort_rows_plain(torch.from_numpy(x)).numpy()))


@pytest.mark.parametrize("L,sort,positions,unsort", [
    (1, "warp", "warp", "warp"), (1024, "warp", "warp", "warp"), (1025, "block", "block", "block"),
    (8192, "block", "block", "block"), (8193, "smem", "smem", "block"), (10957, "smem", "smem", "block"),
    (K.K9_SMEM_MAX[True], "smem", "smem", "block"), (K.K9_SMEM_MAX[True] + 1, "smem", "cluster", "block"),
    (23741, "smem", "cluster", "block"), (K.K9_SMEM_MAX[False], "smem", "cluster", "block"),
    (K.K9_SMEM_MAX[False] + 1, "cluster", "cluster", "block"), (55152, "cluster", "cluster", "block"),
    (55296, "cluster", "cluster", "block"), (55297, "device", "device", "block"),
    (K.UNSORT_BLOCK_MAX, "device", "device", "block"), (K.UNSORT_BLOCK_MAX + 1, "device", "device", "scatter"),
    (65536, "device", "device", "scatter"), (65537, "device", "device", "scatter"),
])
def test_sort_route_and_unsort_route_at_each_edge(L, sort, positions, unsort):
    """The launcher's routes in plain Python: each form's K9_SMEM_MAX is the
    longest row whose block fits 232,448 bytes of shared memory (16,280
    with positions, 24,424 without), the cluster takes 2 to 4 blocks of one
    tile (13,824) each, to 55,296, and the unsort's block route every row of
    floats a block holds (58,112)."""
    assert (K.sort_route(L, False), K.sort_route(L, True), K.unsort_route(L)) == (sort, positions, unsort)
    for wp in (False, True):
        cap = K.K9_SMEM_MAX[wp]
        assert K.row_smem_bytes(cap, K.SMEM_WARPS, wp) <= K.SMEM_LIMIT < K.row_smem_bytes(cap + 1, K.SMEM_WARPS, wp)
        if K.sort_route(L, wp) == "cluster":
            c = K.cluster_size(L)
            assert 2 <= c <= K.CLUSTER_MAX and -(-L // c) <= K.CLUSTER_TILE
            assert K.row_smem_bytes(K.CLUSTER_TILE, K.CLUSTER_WARPS, wp) <= K.SMEM_LIMIT
    assert K.K9_SMEM_MAX == {False: 24424, True: 16280}
    assert [K.cluster_size(n) for n in (16281, 23741, 27648, 27649, 55152)] == [2, 2, 2, 3, 4]


# ----------------------------------------------------------------------
# the radix core of csrc/radix_sort.cuh (tests/_radix_model.py) at K9's
# routes: the default build's ranking (read, write back) and the first
# core's (an atomic add, the SDT_RADIX_CORE_PR6=1 trial build)
# ----------------------------------------------------------------------


def _k9_layout(L, with_positions):
    """(blocks a row, warps a block, items a lane, bits of the position
    payload) of the route K9 takes at ``L`` (``K.sort_route``), as the
    launcher of csrc/sort_rows.cu sets them."""
    route = K.sort_route(L, with_positions)
    if route == "warp":
        return 1, 1, 4 * -(-L // 128), R.POS_BITS
    if route == "block":
        items = 4 if L <= 2048 else 12 if L <= 4096 else 16
        return 1, max(8, -(-L // (32 * items))), items, R.POS_BITS
    if route == "smem":
        return 1, K.SMEM_WARPS, K.SMEM_ITEMS, R.POS_BITS
    if route == "cluster":
        return K.cluster_size(L), K.CLUSTER_WARPS, K.CLUSTER_ITEMS, R.POS_BITS
    return 1, LONG_WARPS, LONG_ITEMS, 32


def _core_rows(rng, L):
    """Rows of NaN payloads (0x7fffffff among them), -NaN, +-0 and +-inf;
    one key (an all-equal row); heavy ties (one key in most places, so that
    a warp's whole column holds one digit) with -0 and +0 among them; daily
    temperatures near 283 K (a constant top byte)."""
    x = _nan_zero_rows(rng, 4, L)
    x[1] = 7.0
    x[2] = 7.0
    x[2, ::19], x[2, ::23] = -0.0, 0.0
    x[2, ::31] = rng.normal(0, 5, x[2, ::31].size)
    x[3] = np.float32(283.5) + rng.normal(0, 1, L).astype(np.float32)
    return x


def _core_sort(x, L, with_positions, ranking, **kw):
    """Each row of ``x`` sorted by the core model on K9's route at ``L``:
    (values, positions)."""
    blocks, warps, items, pos_bits = _k9_layout(L, with_positions)
    kw.setdefault("pos_bits", pos_bits)
    rows = [R.lsd_sort(R.ordered_ukeys(r), blocks, warps, items, ranking, **kw) for r in x]
    return np.stack([R.from_ukeys(k) for k, _ in rows]), np.stack([p for _, p in rows])


# the route edges: a warp and a block a row (1,024 / 1,025), config 8's
# rows, K9_MAX_LEN and one past it, 30 years of days, a chunk of K2's
# 1950-2100 rows, each form's K9_SMEM_MAX and one past it, 16,384 / 16,385
# and 1950-2100 daily rows (a cluster of 4)
CORE_LENGTHS = [1024, 1025, 3650, 8192, 8193, 10957, 13788, 16280, 16281, 16384, 16385, 24424, 24425,
                55152]


@pytest.mark.parametrize("with_positions", [False, True], ids=["sort", "positions"])
@pytest.mark.parametrize("L", CORE_LENGTHS)
@pytest.mark.parametrize("ranking", ["rmw", "atomic"], ids=["rmw", "first"])
def test_radix_core_models_match_the_plain_stable_sort_bitwise(rng, ranking, L, with_positions):
    """Both rankings, on the geometry of the route each form takes at each
    edge (a warp, a block, a block's tiles in shared memory, a cluster's
    blocks), give the stable sort's values and positions bitwise."""
    x = _core_rows(rng, L)
    vals, pos = _core_sort(x, L, with_positions, ranking)
    want_v, want_p = K.sort_rows_with_positions_plain(torch.from_numpy(x))
    npt.assert_array_equal(_bits(vals), _bits(want_v.numpy()))
    npt.assert_array_equal(pos, want_p.numpy())


# each core mutant and the (L, with positions) shapes it must fail at: a
# warp, a block, a block's one tile and two tiles in shared memory, a
# cluster; the warps' and the skip's need more than one warp a row
_ALL = [(620, True), (3650, True), (10957, True), (24424, False), (23741, True)]
CORE_MUTANTS = {"lanes": _ALL, "early_write": _ALL, "stale_read": _ALL, "rank_bits": _ALL,
                "pos_bits": _ALL, "warps": _ALL[1:], "skip": _ALL[1:]}


@pytest.mark.parametrize("mutation", sorted(CORE_MUTANTS))
def test_radix_core_mutants_disagree(rng, mutation):
    """A rank without the lower lanes of its digit, a base without the
    earlier warps, a counter written before its peers read it or read
    before the previous item's write (what each of the two __syncwarp of
    an item prevents), a pass skipped where the first warp's chunk holds
    one digit, a rank field one bit narrower than the longest warp column
    needs and a position payload one bit narrower than the row needs each
    make the model disagree with the stable sort."""
    differs = []
    for L, wp in CORE_MUTANTS[mutation]:
        x = _core_rows(rng, L)
        x[0, : L // 4] = 7.0  # a first chunk of one key in a row that varies
        _, _, items, _ = _k9_layout(L, wp)
        kw = {"rank_bits": (32 * items).bit_length() - 1} if mutation == "rank_bits" else \
            {"pos_bits": (L - 1).bit_length() - 1} if mutation == "pos_bits" else {"mutation": mutation}
        vals, pos = _core_sort(x, L, wp, "rmw", **kw)
        want_v, want_p = K.sort_rows_with_positions_plain(torch.from_numpy(x))
        differs.append(not (np.array_equal(_bits(vals), _bits(want_v.numpy()))
                            and np.array_equal(pos, want_p.numpy())))
    assert all(differs), f"{mutation} agrees at {[s for s, d in zip(CORE_MUTANTS[mutation], differs) if not d]}"


def test_radix_core_payload_halves_hold_every_route():
    """A payload's 16-bit low half holds a warp's counts and ranks on every
    route (at most 1,024 items a warp), and its 16-bit high half every
    position of the routes that carry one there (all but device memory)."""
    for L in (1, 1024, 1025, 2048, 4096, K.K9_MAX_LEN, K.K9_MAX_LEN + 1, K.K9_SMEM_MAX[True],
              K.K9_SMEM_MAX[False], K.CLUSTER_MAX * K.CLUSTER_TILE, K.CLUSTER_MAX * K.CLUSTER_TILE + 1):
        for wp in (False, True):
            _, _, items, pos_bits = _k9_layout(L, wp)
            assert 32 * items <= 1024 < 2**R.RANK_BITS
            assert pos_bits == 32 or L <= 2**R.POS_BITS


# the unsort's warp route: kUnsortWarps rows (warps) a block
UNSORT_WARPS = 8


def _unsort_writes(route, vals, pos):
    """The unsort as the kernel's loops run it on ``route`` (``warp``: warp
    w of block b takes row b * UNSORT_WARPS + w, a lane the 16-byte words
    lane, lane + 32, ... of the row where L is a multiple of 4, else its
    elements; ``scatter``: thread t takes elements 4t..4t+3 of the flat
    array, its row from 4t): (out, how often each out element was written,
    how often each element of a row's shared slice was written).  ``block``:
    block b takes row b with T threads (a multiple of 32, at most 1,024:
    L / 4 words where L is a multiple of 4, else L elements); thread t the
    16-byte words t, t + T, ..., else elements t0 + u * T (u < 4) for t0 =
    t, t + 4T, ...; then the row out, element by element or word by
    word."""
    B, L = vals.shape
    out = np.full(B * L, np.nan, np.float32)
    written = np.zeros(B * L, np.int64)
    slice_writes = np.zeros(B * L, np.int64)
    if route == "block":
        vec = L % 4 == 0
        work = L // 4 if vec else L
        T = min(1024, max(32, -(-work // 32) * 32))
        buf = np.full((B, L), np.nan, np.float32)
        rows = np.arange(B)[:, None]
        for t in range(T):
            if vec:
                cols = (np.arange(t, L // 4, T)[:, None] * 4 + np.arange(4)).ravel()
            else:
                cols = (np.arange(t, L, 4 * T)[:, None] + np.arange(4) * T).ravel()
                cols = cols[cols < L]
            p = pos[:, cols]
            ok = (p >= 0) & (p < L)
            rr = np.broadcast_to(rows, p.shape)
            buf[rr[ok], p[ok]] = vals[:, cols][ok]
            np.add.at(slice_writes, rr[ok] * L + p[ok], 1)
        for t in range(T):  # after __syncthreads
            cols = ((np.arange(t, L // 4, T)[:, None] * 4 + np.arange(4)).ravel() if vec
                    else np.arange(t, L, T))
            flat = (rows * L + cols).ravel()
            out[flat] = buf[:, cols].ravel()
            np.add.at(written, flat, 1)
        return out.reshape(B, L), written, slice_writes
    if route == "warp":
        blocks = -(-B // UNSORT_WARPS)
        rows = np.arange(blocks * UNSORT_WARPS)
        rows = rows[rows < B]  # a warp past the last row returns
        width = 4 if L % 4 == 0 else 1
        buf = np.full((B, L), np.nan, np.float32)
        for lane in range(32):
            cols = (np.arange(lane, L // width, 32)[:, None] * width + np.arange(width)).ravel()
            p = pos[rows][:, cols]
            ok = (p >= 0) & (p < L)
            rr = np.broadcast_to(rows[:, None], p.shape)
            buf[rr[ok], p[ok]] = vals[rows][:, cols][ok]
            np.add.at(slice_writes, rr[ok] * L + p[ok], 1)
        for lane in range(32):  # after __syncwarp
            cols = (np.arange(lane, L // width, 32)[:, None] * width + np.arange(width)).ravel()
            flat = (rows[:, None] * L + cols).ravel()
            out[flat] = buf[rows][:, cols].ravel()
            np.add.at(written, flat, 1)
        return out.reshape(B, L), written, slice_writes
    e0 = 4 * np.arange(-(-B * L // 4))
    base = e0 - e0 % L  # the row of element 4t
    for k in range(4):
        e = e0 + k
        if L % 4:  # element by element, stepping into the next row
            base = np.where(e - base == L, base + L, base)
        keep = e < B * L
        p = pos.ravel()[e[keep]]
        ok = (p >= 0) & (p < L)
        dest = base[keep][ok] + p[ok]
        out[dest] = vals.ravel()[e[keep][ok]]
        np.add.at(written, dest, 1)
    return out.reshape(B, L), written, written


@pytest.mark.parametrize("route,B,L", [
    *(("warp", B, L) for B, L in [(6143, 304), (17, 620), (9, 37), (3, 1024)]),
    *(("scatter", B, L) for B, L in [(6143, 304), (17, 620), (9, 37), (5, 10957), (2, 65536)]),
    *(("block", B, L) for B, L in [(3, 8193), (5, 10957), (2, 23741), (2, 55152), (2, 58112)]),
])
def test_unsort_routes_write_every_element_once_inside_its_row(rng, route, B, L):
    """The unsort's short-row warp route, the block route above 8,192 (a row
    of floats in a block's shared memory, to 58,112) and the straight
    scatter, modelled loop by loop, write every element of every row once
    and inside its row, at row counts that leave a block of UNSORT_WARPS
    rows part full; the result is the plain unsort's, bitwise.  A position
    outside [0, L) is skipped."""
    x = rng.normal(0, 5, (B, L)).astype(np.float32)
    vals = rng.normal(0, 1, (B, L)).astype(np.float32)
    _, pos = K.sort_rows_with_positions_plain(torch.from_numpy(x))
    pos = pos.numpy()
    out, written, slice_writes = _unsort_writes(route, vals, pos)
    npt.assert_array_equal(written, 1)
    npt.assert_array_equal(slice_writes, 1)
    want = K.unsort_rows_plain(torch.from_numpy(vals), torch.from_numpy(pos)).numpy()
    npt.assert_array_equal(_bits(out), _bits(want))
    bad = pos.copy()
    bad[0, 0], bad[-1, -1] = L, -1  # skipped: their targets stay unwritten
    _, written, slice_writes = _unsort_writes(route, vals, bad)
    assert written.max() == 1 and slice_writes.sum() == B * L - 2 and slice_writes.max() == 1


# ----------------------------------------------------------------------
# the BCSD row sort sites: 256 < L goes to K9
# ----------------------------------------------------------------------


def _equal_groups(G, L):
    from skdownscale_tpu_torch.utils.timeindex import PaddedGroups

    return PaddedGroups.from_labels(np.repeat(np.arange(G), L), np.arange(G))


@pytest.mark.parametrize("L", [620, K.K9_MAX_LEN + 1])
def test_sort_within_groups_routes_long_groups_bitwise(rng, L):
    """``_sort_within_groups`` at the dense daily fit's L = 620 and above
    ``K9_MAX_LEN`` (K9's long route on the card) equals
    ``count_sort_segments_plain`` bitwise; at 620 also the JAX site
    (``grouped.py:170``) with the Pallas K9 forced in interpret mode."""
    from skdownscale_tpu.models import grouped as JG
    from skdownscale_tpu.ops import rowsort
    from skdownscale_tpu.utils.timeindex import PaddedGroups as JPG

    from skdownscale_tpu_torch.kernels.rank_map import count_sort_segments_plain
    from skdownscale_tpu_torch.models.grouped import _sort_within_groups

    G = 3
    x = _specials(rng, 4 * G, L).reshape(4, G * L)
    groups = _equal_groups(G, L)
    got = _sort_within_groups(torch.from_numpy(x), groups).numpy()
    npt.assert_array_equal(_bits(got), _bits(count_sort_segments_plain(torch.from_numpy(x), L).numpy()))
    if L == 620:
        jgroups = JPG.from_labels(np.repeat(np.arange(G), L), np.arange(G))
        with rowsort.override(force=True, interpret=True):
            want = np.asarray(JG._sort_within_groups(jnp.asarray(x), jgroups))
        npt.assert_array_equal(_bits(got), _bits(want))


def test_sort_groups_3d_routes_long_windows_bitwise(rng):
    """``_sort_groups_3d`` at Lt = 620: bitwise equal to
    ``count_sort_segments_plain`` and to the JAX site (``streaming.py:75``)
    with the Pallas K9 forced in interpret mode."""
    from skdownscale_tpu.models import streaming as JS
    from skdownscale_tpu.ops import rowsort

    from skdownscale_tpu_torch.kernels.rank_map import count_sort_segments_plain
    from skdownscale_tpu_torch.models.streaming import _sort_groups_3d

    C, Gc, Lt = 3, 4, 620
    x = _specials(rng, C * Gc, Lt).reshape(C, Gc, Lt)
    got = _sort_groups_3d(torch.from_numpy(x), Lt).numpy()
    flat = torch.from_numpy(x.reshape(C, Gc * Lt))
    npt.assert_array_equal(_bits(got), _bits(count_sort_segments_plain(flat, Lt).numpy().reshape(x.shape)))
    with rowsort.override(force=True, interpret=True):
        want = np.asarray(JS._sort_groups_3d(jnp.asarray(x), Lt))
    npt.assert_array_equal(_bits(got), _bits(want))
