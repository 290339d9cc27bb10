"""A numpy model of the CUDA segment count-sort K1 and segment rank-map K2
(``csrc/rank_map.cu``), held bitwise against the port's plain versions.

The model follows the kernel's four routes, chosen by ``L`` as
``kernels/rank_map.route`` chooses them:

* packed (K1: L <= 64, K2: L <= 256): a tile is ``P = 256 // U`` whole
  segments of ``U = ceil(L / 4)`` threads each, thread ``t`` counts places ``u + r*U`` (``u =
  t % U``, ``r < 4``) of segment ``t // U``, the segments staged at a
  stride of ``round_up(L, 4)`` with pad slots that never count; K2
  counts ``#{q_s <= q_t}`` and takes the staged ``res[c - 1]``; K1 writes
  its key at its run end ``#{k_s <= k_t} - 1`` into a row preset to the
  largest key and each slot walks forward to the next set slot (the stable
  rank of the ``SDT_K1_STABLE`` build too);
* warp (L <= 1,024) and block (L <= 16,384): the folded keys (-0 onto +0,
  every NaN onto 0xffffffff) sorted stably with their positions (the
  radix sort itself is modelled in ``tests/test_torch_sort.py``), each
  slot's run end item by item as the kernel finds it (the highest lane
  holding its key, or the reverse min-scan of the SDT_RANK_RUN_END=0
  build), carried from the last item to the first and, on the block route,
  from the later warps' chunks through the first key and first run end of
  each chunk; then ``out[pos] = res[j]``;
* search (L > 16,384): chunks of at most 16,384 sorted, the count a sum of
  upper bounds.

Inputs hold NaN (the payloads 0x7fffffff and 0xffffffff too), +-0, +-inf,
heavy ties, all-NaN and all-equal segments, and segment counts that leave
the last block part full.  Ties taking the run start, -0 not folded onto
+0, NaN counted as a member, and a segment reading its neighbour's last key
must each make the model disagree.  Numpy and torch only, no JAX program.
"""

import numpy as np
import pytest
import torch

from skdownscale_tpu_torch.kernels import rank_map as K

LANES = 32
BIG = np.iinfo(np.int64).max
NAN_KEY = np.uint32(0xFFFFFFFF)
I32_MAX = np.int32(2**31 - 1)
PACKED_THREADS = 256
PACKED_ITEMS = 4  # keys a thread counts


# ----------------------------------------------------------------------
# keys
# ----------------------------------------------------------------------


def _okeys(x):
    """ordered_key: the order-isomorphic int32 key of float32 values."""
    b = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(b >= 0, b, (~b) ^ np.int64(-(2**31))).astype(np.int32)


def _from_okeys(k):
    k = np.asarray(k, np.int32).astype(np.int64)
    b = np.where(k >= 0, k, ~(k ^ np.int64(-(2**31))))
    return (b & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _ukeys(x):
    """ordered_ukey: the ordered key with its sign bit flipped (unsigned order)."""
    return _okeys(x).view(np.uint32) ^ np.uint32(0x80000000)


def _folded(x, mutation=None):
    """K2's folded_ukey: -0 onto +0, every NaN onto 0xffffffff."""
    x = np.asarray(x, np.float32)
    k = _ukeys(x)
    if mutation != "zero":
        k = np.where(x == 0, np.uint32(0x80000000), k)
    if mutation != "nan_member":
        k = np.where(np.isnan(x), NAN_KEY, k)
    return k.astype(np.uint32)


# ----------------------------------------------------------------------
# packed route
# ----------------------------------------------------------------------


def _packed_blocks(n_seg, L):
    """(first segment, segments) of each packed tile, the segments a tile
    P = 256 // U (U = ceil(L / 4) threads a segment) and the stride."""
    U = -(-L // PACKED_ITEMS)
    P = max(1, PACKED_THREADS // U)
    return [(s0, min(P, n_seg - s0)) for s0 in range(0, n_seg, P)], P, (L + 3) & ~3


def _windows(segs, L, Lp, mutation):
    """The places the block's threads count: thread t takes segment t // U
    and places u + r*U (u = t % U, r < 4) below L.  Returns each such
    element's index in the run, segment, place and the staged slots it
    counts over, (n, Lp); the mutant "neighbour" starts every segment but
    the block's first one slot early."""
    U = -(-L // PACKED_ITEMS)
    t = np.arange(segs * U)
    s = np.repeat(t // U, PACKED_ITEMS)
    tl = (t % U)[:, None] + U * np.arange(PACKED_ITEMS)[None, :]
    tl = tl.reshape(-1)
    keep = tl < L
    s, tl = s[keep], tl[keep]
    start = s * Lp
    if mutation == "neighbour":
        start = np.where(s > 0, start - 1, start)
    return s * L + tl, s, tl, start[:, None] + np.arange(Lp)


def packed_k2(xq, res, L, mutation=None):
    """K2's packed route on a flat float32 array of whole segments."""
    out = np.empty_like(xq)
    blocks, P, Lp = _packed_blocks(xq.size // L, L)
    for s0, segs in blocks:
        a = s0 * L
        t, s, tl, win = _windows(segs, L, Lp, mutation)
        q = np.full(P * Lp, np.nan, np.float32)  # pads never count
        q[s * Lp + tl] = xq[a + t]
        r = res[a : a + segs * L]
        v = q[s * Lp + tl][:, None]
        w = q[win]
        with np.errstate(invalid="ignore"):
            if mutation == "nan_member":
                c = (~(w > v)).sum(1)
            elif mutation == "zero":  # ordered keys: -0 below +0
                c = ((_okeys(w) <= _okeys(v)) & ~np.isnan(w) & ~np.isnan(v)).sum(1)
            elif mutation == "run_start":
                c = (w < v).sum(1) + 1
            else:
                c = (w <= v).sum(1)
        idx = s * L + np.clip(c - 1, 0, L - 1)
        out[a + t] = np.where(c > 0, r[idx], np.float32(np.nan))
    return out


def packed_k1(x, L, stable=False, mutation=None):
    """K1's packed route: run end and forward walk (or the stable rank)."""
    out = np.empty_like(x)
    blocks, P, Lp = _packed_blocks(x.size // L, L)
    for s0, segs in blocks:
        a = s0 * L
        t, s, tl, win = _windows(segs, L, Lp, mutation)
        keys = np.full(P * Lp, I32_MAX, np.int32)  # pads: the largest key
        kt = _okeys(x[a + t])
        keys[s * Lp + tl] = kt
        w = keys[win]
        srt = np.full(P * Lp, I32_MAX, np.int32)  # preset: unset
        if stable:
            place = np.arange(Lp)[None, :]
            c = ((w < kt[:, None]) | ((w == kt[:, None]) & (place < tl[:, None]))).sum(1)
            srt[s * Lp + c] = kt
        else:
            c = (w <= kt[:, None]).sum(1) - np.where(kt == I32_MAX, Lp - L, 0)
            if mutation == "run_start":
                c = (w < kt[:, None]).sum(1) + 1
            srt[s * Lp + c - 1] = kt  # tied keys write the same bits
        rows = srt.reshape(P, Lp)[:segs, :L]
        # each slot walks to the next slot that is set (the last always is)
        is_set = rows != I32_MAX
        is_set[:, -1] = True
        nxt = np.where(is_set, np.arange(L), L)
        nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
        out[a : a + segs * L] = _from_okeys(np.take_along_axis(rows, nxt, 1)).reshape(-1)
    return out


# ----------------------------------------------------------------------
# warp and block routes: sort with positions, run-end scan, fill
# ----------------------------------------------------------------------


def _run_end_match(key, after, more, base, carry):
    """run_end_match of one item (the default): each lane's highest peer
    (the lanes holding its key), or the carry where the run goes on past
    lane 31 into the next slot of the row (``more``)."""
    hi = np.array([np.nonzero(key == k)[0].max() for k in key])
    return np.where((hi == LANES - 1) & more & (key == after), carry, base + hi)


def _run_end(key, after, m, last, carry):
    """run_end of one item by the reverse min-scan (SDT_RANK_RUN_END=0):
    key, m (32,), the key after lane 31, the carry."""
    nxt = np.append(key[1:], after)
    j = np.where((m >= last) | (key != nxt), m, BIG)
    lane = np.arange(LANES)
    for d in (1, 2, 4, 8, 16):
        o = np.append(j[d:], np.full(d, BIG))  # __shfl_down_sync
        j = np.where(lane + d < LANES, np.minimum(j, o), j)
    return np.minimum(j, carry)


def _sorted(xq, mutation):
    k = _folded(xq, mutation)
    order = np.argsort(k, kind="stable")
    return k[order], order


def _fill(xq, res, keys, pos, j, L):
    out = np.empty(L, np.float32)
    out[pos] = np.where(keys == NAN_KEY, np.float32(np.nan), res[np.minimum(j, L - 1)])
    return out


def _run_starts(keys):
    """The mutant's rank: each slot's run start."""
    m = np.arange(keys.size)
    start = np.ones(keys.size, bool)
    start[1:] = keys[1:] != keys[:-1]
    return np.maximum.accumulate(np.where(start, m, -1))


def _item_run_end(form, key, after, m, L, carry):
    """One item's run ends by the kernel's form (``"match"`` or ``"scan"``)."""
    if form == "match":
        return _run_end_match(key, after, m[0] + LANES < L, m[0], carry)
    return _run_end(key, after, m, L - 1, carry)


def warp_k2(xq, res, L, mutation=None, form="match"):
    """K2's warp route on one segment."""
    keys, pos = _sorted(xq, mutation)
    if mutation == "run_start":
        return _fill(xq, res, keys, pos, _run_starts(keys), L)
    items = (L + 127) // 128 * 4
    reg = np.full(items * LANES, NAN_KEY, np.uint32)  # pads past the row
    reg[:L] = keys
    reg = reg.reshape(items, LANES)
    j = np.empty(items * LANES, np.int64)
    carry, after = BIG, np.uint32(0)
    for i in reversed(range(items)):
        if i * LANES >= L:
            continue
        m = i * LANES + np.arange(LANES)
        ji = _item_run_end(form, reg[i], after, m, L, carry)
        carry, after = ji[0], reg[i][0]
        j[m] = ji
    return _fill(xq, res, keys, pos, j[:L], L)


def _block_shape(L):
    items = 4 if L <= 2048 else 12 if L <= 4096 else 16 if L <= 8192 else 32
    return items, max(8, -(-L // (items * LANES)))


def block_k2(xq, res, L, mutation=None, form="match"):
    """K2's block route on one segment: each warp's chunk scanned alone,
    then the later chunks' least run end where a chunk has none."""
    keys, pos = _sorted(xq, mutation)
    if mutation == "run_start":
        return _fill(xq, res, keys, pos, _run_starts(keys), L)
    items, n_warps = _block_shape(L)
    chunk = items * LANES
    reg = np.full(n_warps * chunk, NAN_KEY, np.uint32)
    reg[:L] = keys
    reg = reg.reshape(n_warps, items, LANES)
    first_key = reg[:, 0, 0]
    j16 = np.empty(n_warps * chunk, np.int64)
    first_end = np.full(n_warps, BIG)
    for w in range(n_warps):
        c0, n = w * chunk, min(chunk, L - w * chunk)
        carry = BIG
        after = first_key[w + 1] if w + 1 < n_warps else np.uint32(0)
        for i in reversed(range(items)):
            if i * LANES >= n:
                continue
            m = c0 + i * LANES + np.arange(LANES)
            ji = _item_run_end(form, reg[w, i], after, m, L, carry)
            carry, after = ji[0], reg[w, i][0]
            j16[m] = np.minimum(ji, 0xFFFF)
        if n > 0:
            first_end[w] = carry
    j = j16[:L].copy()
    for w in range(n_warps):
        c0, n = w * chunk, min(chunk, L - w * chunk)
        if n <= 0:
            continue
        later = first_end[w + 1 :].min(initial=BIG)
        sl = slice(c0, c0 + n)
        j[sl] = np.where(j[sl] == 0xFFFF, later, j[sl])
    return _fill(xq, res, keys, pos, j, L)


def search_k2(xq, res, L, mutation=None, form=None):
    """K2's search route on one segment: chunks of at most 16,384 sorted,
    each query's count a sum of upper bounds."""
    k = _folded(xq, mutation)
    C = -(-L // K.BLOCK_MAX)
    Lc = -(-L // C)
    c = sum(np.searchsorted(np.sort(k[a : a + Lc]), k, side="right") for a in range(0, L, Lc))
    if mutation == "run_start":
        c = sum(np.searchsorted(np.sort(k[a : a + Lc]), k, side="left") for a in range(0, L, Lc)) + 1
    return np.where(k == NAN_KEY, np.float32(np.nan), res[np.clip(c - 1, 0, L - 1)])


def model_k2(xq, res, L, mutation=None, search_min=None, form="match"):
    """K2 on (B, G*L) by the route the launcher takes (``search_min``: the
    SDT_K2_SEARCH_MIN build; ``form``: the run ends' form)."""
    flat, rflat = xq.reshape(-1), res.reshape(-1)
    rt = K.route("rank_map_segments", L)
    if search_min is not None and rt != "packed" and L >= search_min:
        rt = "search"
    if rt == "packed":
        return packed_k2(flat, rflat, L, mutation).reshape(xq.shape)
    one = {"warp": warp_k2, "block": block_k2, "search": search_k2}[rt]
    rows = [one(flat[a : a + L], rflat[a : a + L], L, mutation, form) for a in range(0, flat.size, L)]
    return np.concatenate(rows).reshape(xq.shape)


def model_k1(x, L, stable=False, mutation=None):
    """K1 on (B, G*L): the packed route, or the warp route's stable sort."""
    if K.route("count_sort_segments", L) == "packed":
        return packed_k1(x.reshape(-1), L, stable, mutation).reshape(x.shape)
    return _from_okeys(np.sort(_okeys(x.reshape(-1, L)), axis=1)).reshape(x.shape)


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------


def _segments(rng, n_seg, L):
    """float32 (n_seg, L): NaN (payloads 0x7fffffff and 0xffffffff among
    them), -NaN, +-inf, +-0, heavy ties, an all-NaN and an all-equal
    segment, and a segment of zeros of both signs."""
    x = rng.normal(0, 50, (n_seg, L)).astype(np.float32)
    flat = x.reshape(-1)
    specials = np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0xFFC00000, 0x7F800000,
                         0xFF800000, 0x00000000, 0x80000000], np.uint32).view(np.float32)
    for v in specials:
        flat[rng.integers(0, flat.size, max(1, flat.size // 150))] = v
    tied = rng.random(n_seg) < 0.3
    x[tied] = np.round(x[tied] / 25) * 25  # heavy ties (and -0 from rounding)
    if n_seg > 3:
        x[1] = np.nan
        x[2] = 7.0
        x[3] = np.where(rng.random(L) < 0.5, np.float32(0.0), np.float32(-0.0))
    return x


def _res(rng, n_seg, L):
    return np.sort(rng.normal(0, 1, (n_seg, L)).astype(np.float32), axis=1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _plain_k2(x, r, L):
    return K.rank_map_segments_plain(torch.from_numpy(x), torch.from_numpy(r), L).numpy()


def _plain_k1(x, L):
    return K.count_sort_segments_plain(torch.from_numpy(x), L).numpy()


# (B, G, L): the packed route with its last block part full (P = 512 // L
# segments a block), the route edges 64 / 65, 1,024 / 1,025 and 16,384 /
# 16,385, config 9a's L = 730, warp blocks of four segments part full
K2_SHAPES = [
    (700, 1, 1), (20, 5, 7), (12, 5, 20), (41, 1, 40), (7, 12, 40), (30, 1, 41), (21, 1, 64),
    (9, 1, 65), (5, 2, 256), (9, 1, 257), (5, 1, 730), (3, 2, 1024), (2, 1, 1025), (1, 1, 16384),
    (2, 1, 16385),
]
K1_SHAPES = [s for s in K2_SHAPES if s[2] <= K.COUNT_SORT_MAX_LEN]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.mark.parametrize("B,G,L", K2_SHAPES)
def test_k2_model_matches_the_plain_version_bitwise(rng, B, G, L):
    x = _segments(rng, B * G, L).reshape(B, G * L)
    r = _res(rng, B * G, L).reshape(B, G * L)
    np.testing.assert_array_equal(_bits(model_k2(x, r, L)), _bits(_plain_k2(x, r, L)))


@pytest.mark.parametrize("L", [257, 730, 1025, 16384])
def test_k2_search_trial_matches_the_plain_version_bitwise(rng, L):
    """The SDT_K2_SEARCH_MIN=257 build: the search route at every L above
    the packed route."""
    x, r = _segments(rng, 4, L), _res(rng, 4, L)
    np.testing.assert_array_equal(_bits(model_k2(x, r, L, search_min=257)), _bits(_plain_k2(x, r, L)))


@pytest.mark.parametrize("L", [257, 730, 1024, 1025, 4000, 16384])
def test_k2_run_ends_by_scan_match_the_plain_version_bitwise(rng, L):
    """The SDT_RANK_RUN_END=0 build: run ends by the reverse min-scan."""
    x, r = _segments(rng, 5, L), _res(rng, 5, L)
    np.testing.assert_array_equal(_bits(model_k2(x, r, L, form="scan")), _bits(_plain_k2(x, r, L)))


@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("B,G,L", K1_SHAPES)
def test_k1_model_matches_the_plain_version_bitwise(rng, B, G, L, stable):
    x = _segments(rng, B * G, L).reshape(B, G * L)
    np.testing.assert_array_equal(_bits(model_k1(x, L, stable)), _bits(_plain_k1(x, L)))


@pytest.mark.parametrize(
    "kernel,mutation",
    [("rank_map_segments", m) for m in ("run_start", "zero", "nan_member", "neighbour")]
    + [("count_sort_segments", m) for m in ("run_start", "neighbour")],
)
def test_a_broken_rule_disagrees(rng, kernel, mutation):
    """Each mutant must differ from the plain version at one shape at
    least: the packed shapes for every mutant, the radix routes for those
    that apply there."""
    shapes = [(41, 1, 40), (5, 1, 730), (2, 1, 1025), (2, 1, 16385)]
    if mutation == "neighbour" or kernel == "count_sort_segments":
        shapes = shapes[:1]
    differs = []
    for B, G, L in shapes:
        x = _segments(rng, B * G, L).reshape(B, G * L)
        if kernel == "rank_map_segments":
            r = _res(rng, B * G, L).reshape(B, G * L)
            got, want = model_k2(x, r, L, mutation), _plain_k2(x, r, L)
        else:
            got, want = model_k1(x, L, mutation=mutation), _plain_k1(x, L)
        differs.append(not np.array_equal(_bits(got), _bits(want)))
    assert all(differs), f"{kernel} {mutation}: agrees at {[s for s, d in zip(shapes, differs) if not d]}"


def test_route_by_length():
    """The launcher's routes by L (csrc/rank_map.cu k1_route / k2_route)."""
    k1 = {L: K.route("count_sort_segments", L) for L in (1, 40, 64, 65, 240, 256)}
    assert k1 == {1: "packed", 40: "packed", 64: "packed", 65: "warp", 240: "warp", 256: "warp"}
    k2 = {L: K.route("rank_map_segments", L) for L in
          (1, 40, 65, 240, 256, 257, 730, 1024, 1025, 16384, 16385, 55152, 2**20)}
    assert k2 == {1: "packed", 40: "packed", 65: "packed", 240: "packed", 256: "packed",
                  257: "warp", 730: "warp", 1024: "warp", 1025: "block", 16384: "block",
                  16385: "search", 55152: "search", 2**20: "search"}
    for kernel, L in (("count_sort_segments", 257), ("rank_map_segments", 0)):
        with pytest.raises(ValueError):
            K.route(kernel, L)


def test_packed_tiles_hold_whole_segments_and_leave_no_ragged_lanes():
    """At config 2's L = 40 a tile holds 25 segments of 10 threads, 250 of
    256 threads busy; at every packed L a thread owns at most 4 places of
    one segment, a segment idles at most 3, and a tile's last warp is the
    only one with idle lanes."""
    _, P, Lp = _packed_blocks(131_072 * 12, 40)
    assert (P, Lp) == (25, 40)
    for L in range(1, K.SHORT_MAX["rank_map_segments"] + 1):
        _, P, Lp = _packed_blocks(10, L)
        U = -(-L // PACKED_ITEMS)
        threads = P * U
        assert threads <= PACKED_THREADS and U * PACKED_ITEMS - L < PACKED_ITEMS
        assert Lp % 4 == 0 and Lp - L < 4 and -(-threads // 32) * 32 - threads < 32
        idx, s, tl, _ = _windows(P, L, Lp, None)
        assert np.array_equal(np.sort(idx), np.arange(P * L))  # every element once
