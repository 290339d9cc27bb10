"""The port's row sort K9 (``kernels/sort_rows.py``) on the CPU: the plain
versions of its three forms against the Pallas kernel of
``skdownscale_tpu/ops/pallas/sort_kernel.py`` in interpret mode, at the
shapes and special rows of ``tests/test_sort_kernel.py``; the stable tie
order; the TPU kernel's pad-position fault (ROADMAP F8); and the BCSD row
sort sites, which route 256 < L <= K9_MAX_LEN to K9.

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


# ----------------------------------------------------------------------
# the BCSD row sort sites: 256 < L <= K9_MAX_LEN goes to K9
# ----------------------------------------------------------------------


def _equal_groups(G, L):
    from skdownscale_tpu_torch.utils.timeindex import PaddedGroups

    return PaddedGroups.from_labels(np.repeat(np.arange(G), L), np.arange(G))


@pytest.mark.parametrize("L", [620, K.K9_MAX_LEN + 1])
def test_sort_within_groups_routes_long_groups_bitwise(rng, L):
    """``_sort_within_groups`` at the dense daily fit's L = 620 (K9) and
    above ``K9_MAX_LEN`` (plain) equals ``count_sort_segments_plain``
    bitwise; at 620 also the JAX site (``grouped.py:170``) with the Pallas
    K9 forced in interpret mode."""
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
