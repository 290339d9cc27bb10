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
  largest key and each slot walks forward to the next set slot;
* warp (L <= 1,024) and block (L <= 16,384): the folded keys (-0 onto +0,
  every NaN onto 0xffffffff) sorted stably with their positions (the
  radix sort itself is modelled in ``tests/test_torch_sort.py``), each
  slot's run end item by item as the kernel finds it (the highest lane
  holding its key), carried from the last item to the first and, on the
  block route, from the later warps' chunks through the first key and
  first run end of each chunk; then ``out[pos] = res[j]``;
* staged (L > 16,384): C chunks of at most 16,384 sorted, each into a slot
  of 16,384 words laid out as a search tree in breadth-first order (slot 0
  the 16,384th member, pads 0xffffffff); a block a chunk of queries, 16 a
  thread, walks the tree 14 levels a chunk, and a query's count is the sum
  of the leaves it reaches less 2^14, plus one where slot 0 <= key;
* search (the ``SDT_K2_SEARCH_ROUTE=1`` trial build, L > 16,384): the same
  chunks sorted, the count a sum of upper bounds.

Inputs hold NaN (the payloads 0x7fffffff and 0xffffffff too), +-0, +-inf,
heavy ties, all-NaN and all-equal segments, and segment counts that leave
the last block part full; above 16,384 also tie runs across each chunk
boundary with NaN among them, and -0 and +0 in different chunks.  Ties
taking the run start, -0 not folded onto +0, NaN counted as a member, a
segment reading its neighbour's last key, and on the staged route a strict
``<`` in one foreign chunk, a run end that stops at the query's own chunk
boundary, -0 left unfolded in one chunk and the 16,384th member left out
must each make the model disagree.  Numpy and torch only, no JAX program.
"""

import numpy as np
import pytest
import torch

from skdownscale_tpu_torch.kernels import rank_map as K

import _radix_model as R

LANES = 32
BIG = np.iinfo(np.int64).max
NAN_KEY = np.uint32(0xFFFFFFFF)
I32_MAX = np.int32(2**31 - 1)
PACKED_THREADS = 256
PACKED_ITEMS = 4  # keys a thread counts
TREE_LEVELS = 14  # levels of a chunk's search tree on the staged route
STAGED_ITEMS = 16  # queries a thread on the staged route


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


def packed_k1(x, L, mutation=None):
    """K1's packed route: run end and forward walk."""
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
# warp and block routes: sort with positions, run ends, fill
# ----------------------------------------------------------------------


def _run_end_match(key, after, more, base, carry):
    """run_end_match of one item: each lane's highest peer (the lanes
    holding its key), or the carry where the run goes on past lane 31 into
    the next slot of the row (``more``)."""
    hi = np.array([np.nonzero(key == k)[0].max() for k in key])
    return np.where((hi == LANES - 1) & more & (key == after), carry, base + hi)


# the rankings of csrc/radix_sort.cuh (tests/_radix_model.py) by core: the
# default build's (read, write back) or the first core's (SDT_RADIX_CORE_PR6=1)
CORE_RANKING = {"rmw": "rmw", "first": "atomic"}
CHUNK_ITEMS = 16  # keys a lane of the staged route's chunk sort on the default build


def _sorted(xq, mutation, core=None, layout=None, core_mutation=None):
    """The folded keys sorted stably with their positions: by argsort, or
    (``core``) by the radix core's model on ``layout`` (warps, items)."""
    k = _folded(xq, mutation)
    if core is None:
        order = np.argsort(k, kind="stable")
        return k[order], order
    warps, items = layout
    return R.lsd_sort(k, 1, warps, items, CORE_RANKING[core], mutation=core_mutation)


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


def _item_run_end(key, after, m, L, carry):
    """One item's run ends."""
    return _run_end_match(key, after, m[0] + LANES < L, m[0], carry)


def warp_k2(xq, res, L, mutation=None, core=None, core_mutation=None):
    """K2's warp route on one segment."""
    items = (L + 127) // 128 * 4
    keys, pos = _sorted(xq, mutation, core, (1, items), core_mutation)
    if mutation == "run_start":
        return _fill(xq, res, keys, pos, _run_starts(keys), L)
    reg = np.full(items * LANES, NAN_KEY, np.uint32)  # pads past the row
    reg[:L] = keys
    reg = reg.reshape(items, LANES)
    j = np.empty(items * LANES, np.int64)
    carry, after = BIG, np.uint32(0)
    for i in reversed(range(items)):
        if i * LANES >= L:
            continue
        m = i * LANES + np.arange(LANES)
        ji = _item_run_end(reg[i], after, m, L, carry)
        carry, after = ji[0], reg[i][0]
        j[m] = ji
    return _fill(xq, res, keys, pos, j[:L], L)


def _block_shape(L):
    items = 4 if L <= 2048 else 12 if L <= 4096 else 16 if L <= 8192 else 32
    return items, max(8, -(-L // (items * LANES)))


def block_k2(xq, res, L, mutation=None, core=None, core_mutation=None):
    """K2's block route on one segment: each warp's chunk scanned alone,
    then the later chunks' least run end where a chunk has none."""
    items, n_warps = _block_shape(L)
    keys, pos = _sorted(xq, mutation, core, (n_warps, items), core_mutation)
    if mutation == "run_start":
        return _fill(xq, res, keys, pos, _run_starts(keys), L)
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
            ji = _item_run_end(reg[w, i], after, m, L, carry)
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


def tree_slot(p):
    """csrc/rank_map.cu tree_slot: the slot of a chunk's sorted member p
    (< 16,384): member 16,383 to slot 0, member p below it to in-order node
    q = p + 1 of the perfect tree in breadth-first order, z = (trailing
    zeros of q) levels above the leaves, index q >> (z + 1) in its level."""
    q = np.asarray(p, np.int64) + 1
    z = np.minimum(np.frexp((q & -q).astype(np.float64))[1] - 1, TREE_LEVELS - 1)
    return np.where(q == K.CHUNK_SLOTS, 0, (1 << (TREE_LEVELS - 1 - z)) + (q >> (z + 1)))


TREE_SLOT = tree_slot(np.arange(K.CHUNK_SLOTS))


def slot_member(s):
    """csrc/rank_map.cu slot_member, tree_slot's inverse: the sorted member
    slot s holds (slot 0 the last; slot s at level v = floor(log2 s) the
    in-order node (2 (s - 2^v) + 1) << (13 - v), less one)."""
    s = np.asarray(s, np.int64)
    v = np.floor(np.log2(np.maximum(s, 1))).astype(np.int64)
    return np.where(s == 0, K.CHUNK_SLOTS - 1, ((2 * (s - (1 << v)) + 1) << (TREE_LEVELS - 1 - v)) - 1)


SLOT_MEMBER = slot_member(np.arange(K.CHUNK_SLOTS))


def _chunk_sort_layout(n, core):
    """(warps, items) of the chunk sort of ``n`` keys: 16 keys a lane on the
    default build, the first core's block geometry on its own."""
    if core == "first":
        items, warps = _block_shape(n)
        return warps, items
    return max(8, -(-n // (CHUNK_ITEMS * LANES))), CHUNK_ITEMS


def chunk_slot(members, core=None, core_mutation=None):
    """A chunk's scratch slot as the sort kernel writes it: the sorted
    members, then pads (0xffffffff).  Without ``core`` (and on the first
    core, sorted by its model) each member is stored at its tree slot; the
    default build sorts the chunk into its key buffer and each slot takes
    the member it holds, ``slot_member``."""
    srt = np.full(K.CHUNK_SLOTS, NAN_KEY, np.uint32)
    if core is None:
        srt[: members.size] = np.sort(members)
    else:
        layout = _chunk_sort_layout(members.size, core)
        srt[: members.size], _ = R.lsd_sort(members, 1, *layout, CORE_RANKING[core], with_positions=False,
                                            mutation=core_mutation)
    if core == "rmw":
        return srt[SLOT_MEMBER]
    slot = np.empty_like(srt)
    slot[TREE_SLOT] = srt
    return slot


def tree_count(slot, k, strict=False, top=True):
    """Each query's count in a staged chunk: 14 steps down the tree (node
    i's children 2i and 2i + 1), the leaf less 2^14, plus one where slot 0
    (the 16,384th member) <= key (``strict``: ``<``, a mutant; ``top=False``
    leaves slot 0 out, a mutant)."""
    le = np.less if strict else np.less_equal
    node = np.ones(k.size, np.intp)
    v = np.empty(k.size, np.uint32)
    b = np.empty(k.size, bool)
    for _ in range(TREE_LEVELS):
        np.take(slot, node, out=v)
        le(v, k, out=b)
        node <<= 1
        node += b
    return node - K.CHUNK_SLOTS + (le(slot[0], k) if top else 0)


def staged_blocks(L):
    """The staged route's second kernel on one segment: (start, len) of each
    block's chunk of queries, and its threads (a multiple of 32, 16 queries
    a thread)."""
    C, Lc = K.long_chunks(L)
    threads = -(-(-(-Lc // STAGED_ITEMS)) // LANES) * LANES
    return [(j * Lc, min(Lc, L - j * Lc)) for j in range(C)], threads


def staged_k2(xq, res, L, mutation=None, core=None, core_mutation=None):
    """K2's staged route on one segment: chunk j's slot searched by every
    query of the segment (each block walks all C slots), the counts summed,
    out = res[c - 1].  Mutants: "foreign_strict" (chunk 0 counted with
    ``<`` by the queries of the other chunks), "chunk_run_end" (the chunks
    after a query's own counted with ``<``: its run end stops at its
    chunk's boundary), "zero_one_chunk" (chunk 1's loads, members and
    queries, keep -0 below +0), "no_top" (slot 0 left out)."""
    C, Lc = K.long_chunks(L)
    k = _folded(xq, mutation)
    if mutation == "zero_one_chunk":
        k[Lc : 2 * Lc] = _folded(xq[Lc : 2 * Lc], "zero")
    own = np.arange(L) // Lc  # the chunk, and block, of each query
    c = np.zeros(L, np.int64)
    for j in range(C):
        slot = chunk_slot(k[j * Lc : (j + 1) * Lc], core, core_mutation)
        strict = {"run_start": True, "foreign_strict": (own != 0) & (j == 0), "chunk_run_end": j > own}
        s = strict.get(mutation, False)
        if np.all(s):
            c += tree_count(slot, k, strict=True)
        elif not np.any(s):
            c += tree_count(slot, k, top=mutation != "no_top")
        else:
            c += np.where(s, tree_count(slot, k, strict=True), tree_count(slot, k))
    if mutation == "run_start":
        c += 1
    return np.where(k == NAN_KEY, np.float32(np.nan), res[np.clip(c - 1, 0, L - 1)])


def search_k2(xq, res, L, mutation=None):
    """The search trial (SDT_K2_SEARCH_ROUTE=1) on one segment: the same
    chunks sorted, each query's count a sum of upper bounds."""
    k = _folded(xq, mutation)
    C, Lc = K.long_chunks(L)
    c = sum(np.searchsorted(np.sort(k[a : a + Lc]), k, side="right") for a in range(0, L, Lc))
    if mutation == "run_start":
        c = sum(np.searchsorted(np.sort(k[a : a + Lc]), k, side="left") for a in range(0, L, Lc)) + 1
    return np.where(k == NAN_KEY, np.float32(np.nan), res[np.clip(c - 1, 0, L - 1)])


def model_k2(xq, res, L, mutation=None, search=False, core=None, core_mutation=None):
    """K2 on (B, G*L) by the route the launcher takes (``search``: the
    SDT_K2_SEARCH_ROUTE=1 build); ``core``: the radix routes' sorts by the
    model of that ranking (tests/_radix_model.py), else by argsort."""
    flat, rflat = xq.reshape(-1), res.reshape(-1)
    rt = K.route("rank_map_segments", L)
    if search and rt == "staged":
        rt = "search"
    if rt == "packed":
        return packed_k2(flat, rflat, L, mutation).reshape(xq.shape)
    one = {"warp": warp_k2, "block": block_k2, "staged": staged_k2, "search": search_k2}[rt]
    kw = {} if rt == "search" else {"core": core, "core_mutation": core_mutation}
    rows = [one(flat[a : a + L], rflat[a : a + L], L, mutation, **kw) for a in range(0, flat.size, L)]
    return np.concatenate(rows).reshape(xq.shape)


def model_k1(x, L, mutation=None, core=None):
    """K1 on (B, G*L): the packed route, or the warp route's stable sort
    (by numpy, or ``core``: by the radix core's model on the warp's
    ``4 * ceil(L / 128)`` items a lane, without positions)."""
    if K.route("count_sort_segments", L) == "packed":
        return packed_k1(x.reshape(-1), L, mutation).reshape(x.shape)
    if core is None:
        return _from_okeys(np.sort(_okeys(x.reshape(-1, L)), axis=1)).reshape(x.shape)
    items = (L + 127) // 128 * 4
    keys = np.stack([R.lsd_sort(k, 1, 1, items, CORE_RANKING[core], with_positions=False)[0]
                     for k in _ukeys(x.reshape(-1, L))])
    return _from_okeys((keys ^ np.uint32(0x80000000)).view(np.int32)).reshape(x.shape)


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


def _long_segments(rng, n_seg, L, kind):
    """float32 (n_seg, L > 16,384): Gaussian ("gauss"), or the data of
    :func:`_segments` ("long") with, in each segment that is not all NaN or
    all equal, a tie run of 80 across each chunk boundary of the staged
    route with two NaN among it, and -0 and +0 each in chunk 0 and chunk 1."""
    if kind == "gauss":
        return rng.normal(0, 1, (n_seg, L)).astype(np.float32)
    x = _segments(rng, n_seg, L)
    _, Lc = K.long_chunks(L)
    for r in range(n_seg):
        if n_seg > 3 and r in (1, 2):
            continue
        for b in range(Lc, L, Lc):
            x[r, b - 40 : b + 40] = np.float32(12.5 + r)
            x[r, [b - 3, b + 5]] = np.nan
        p0, p1 = rng.choice(Lc - 50, 8, replace=False), Lc + rng.choice(Lc - 50, 8, replace=False)
        x[r, p0[:4]], x[r, p0[4:]] = np.float32(-0.0), np.float32(0.0)
        x[r, p1[:4]], x[r, p1[4:]] = np.float32(0.0), np.float32(-0.0)
    return x


def _data(rng, B, G, L, kind="segments"):
    """(B, G*L) inputs: :func:`_segments`, or :func:`_long_segments` of
    ``kind``."""
    if kind == "segments":
        return _segments(rng, B * G, L).reshape(B, G * L)
    return _long_segments(rng, B * G, L, kind).reshape(B, G * L)


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


# the staged route's lengths: one past the block route, its chunk-count
# edges (2 chunks of 16,384 / 3 of 10,923; 4 of 12,289 past 3 of 16,384),
# 1950-2014 and 1950-2100 daily, and one row of 65 chunks
LONG_LENGTHS = [16385, 16386, 23741, 32768, 32769, 49153, 55152, 2**20 + 1]


@pytest.mark.parametrize("kind", ["long", "gauss"])
@pytest.mark.parametrize("L", LONG_LENGTHS)
def test_k2_staged_route_matches_the_plain_version_bitwise(rng, L, kind):
    """The staged route (chunk slots as search trees, a block a chunk of
    queries walking every slot) on tie runs across each chunk boundary with
    NaN among them, -0 and +0 in different chunks, the data of _segments
    (all-NaN and all-equal segments among them), and on Gaussian data."""
    assert K.route("rank_map_segments", L) == "staged"
    B = 1 if L > 2**20 else 4
    x, r = _data(rng, B, 1, L, kind), _res(rng, B, L)
    np.testing.assert_array_equal(_bits(model_k2(x, r, L)), _bits(_plain_k2(x, r, L)))


@pytest.mark.parametrize("L", [16385, 32769, 49152, 55152])
def test_k2_search_trial_matches_the_plain_version_bitwise(rng, L):
    """The SDT_K2_SEARCH_ROUTE=1 build: the search route above 16,384."""
    x, r = _data(rng, 4, 1, L, "long"), _res(rng, 4, L)
    np.testing.assert_array_equal(_bits(model_k2(x, r, L, search=True)), _bits(_plain_k2(x, r, L)))


@pytest.mark.parametrize("B,G,L", K1_SHAPES)
def test_k1_model_matches_the_plain_version_bitwise(rng, B, G, L):
    x = _segments(rng, B * G, L).reshape(B, G * L)
    np.testing.assert_array_equal(_bits(model_k1(x, L)), _bits(_plain_k1(x, L)))


# the staged route's mutants and the shapes (B, G, L, data) each must fail
# at: the tie runs across chunk boundaries, -0 and +0 in different chunks;
# slot 0 holds a member only where a chunk is 16,384 long (and NaN-free)
LONG_MUTANTS = {
    "foreign_strict": [(2, 1, 16385, "long"), (1, 1, 55152, "long")],
    "chunk_run_end": [(2, 1, 16385, "long"), (1, 1, 55152, "long")],
    "zero_one_chunk": [(2, 1, 16385, "long"), (1, 1, 55152, "long")],
    "no_top": [(1, 1, 32768, "gauss"), (1, 1, 49152, "gauss")],
}


@pytest.mark.parametrize(
    "kernel,mutation",
    [("rank_map_segments", m) for m in ("run_start", "zero", "nan_member", "neighbour", *LONG_MUTANTS)]
    + [("count_sort_segments", m) for m in ("run_start", "neighbour")],
)
def test_a_broken_rule_disagrees(rng, kernel, mutation):
    """Each mutant must differ from the plain version at one shape at
    least: the packed shapes for every mutant, the radix and staged routes
    for those that apply there, the staged route's own at long shapes."""
    shapes = [(41, 1, 40, "segments"), (5, 1, 730, "segments"), (2, 1, 1025, "segments"),
              (2, 1, 16385, "segments")]
    if mutation == "neighbour" or kernel == "count_sort_segments":
        shapes = shapes[:1]
    shapes = LONG_MUTANTS.get(mutation, shapes)
    differs = []
    for B, G, L, kind in shapes:
        x = _data(rng, B, G, L, kind)
        if kernel == "rank_map_segments":
            r = _res(rng, B * G, L).reshape(B, G * L)
            got, want = model_k2(x, r, L, mutation), _plain_k2(x, r, L)
        else:
            got, want = model_k1(x, L, mutation=mutation), _plain_k1(x, L)
        differs.append(not np.array_equal(_bits(got), _bits(want)))
    assert all(differs), f"{kernel} {mutation}: agrees at {[s for s, d in zip(shapes, differs) if not d]}"


@pytest.mark.parametrize("L", [16385, 23741, 32768, 32769, 55152, 2**20 + 1])
def test_staged_blocks_take_each_query_once_and_a_slot_each_member_once(L):
    """On the staged route every query of a segment is item i of thread t
    of one block (query i * threads + t of its chunk), the threads a whole
    number of warps (at most 1,024) of which only the last has idle items,
    and the tree slots are a permutation of a chunk slot's 16,384 words."""
    blocks, threads = staged_blocks(L)
    longest = max(n for _, n in blocks)
    assert threads % LANES == 0 and threads <= 1024
    assert (threads - LANES) * STAGED_ITEMS < longest <= threads * STAGED_ITEMS
    taken = np.zeros(L, np.int64)
    for start, n in blocks:
        t = (np.arange(STAGED_ITEMS)[:, None] * threads + np.arange(threads)[None, :]).ravel()
        np.add.at(taken, start + t[t < n], 1)
    assert (taken == 1).all()
    assert np.array_equal(np.sort(TREE_SLOT), np.arange(K.CHUNK_SLOTS))


def test_route_by_length():
    """The launcher's routes by L (csrc/rank_map.cu k1_route / k2_route)."""
    k1 = {L: K.route("count_sort_segments", L) for L in (1, 40, 64, 65, 240, 256)}
    assert k1 == {1: "packed", 40: "packed", 64: "packed", 65: "warp", 240: "warp", 256: "warp"}
    k2 = {L: K.route("rank_map_segments", L) for L in
          (1, 40, 65, 240, 256, 257, 730, 1024, 1025, 16384, 16385, 55152, 2**20)}
    assert k2 == {1: "packed", 40: "packed", 65: "packed", 240: "packed", 256: "packed",
                  257: "warp", 730: "warp", 1024: "warp", 1025: "block", 16384: "block",
                  16385: "staged", 55152: "staged", 2**20: "staged"}
    chunks = {L: K.long_chunks(L) for L in (16385, 32768, 32769, 49152, 49153, 55152, 2**20)}
    assert chunks == {16385: (2, 8193), 32768: (2, 16384), 32769: (3, 10923), 49152: (3, 16384),
                      49153: (4, 12289), 55152: (4, 13788), 2**20: (64, 16384)}
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


# the radix routes at the radix core's edges: config 9a's L = 730 (a
# warp), 1,024 / 1,025, 3,650 and 16,384 (a block of 16 warps of 32 keys)
CORE_K2_SHAPES = [(5, 1, 730), (3, 2, 1024), (2, 1, 1025), (2, 1, 3650), (1, 1, 16384)]


@pytest.mark.parametrize("B,G,L", CORE_K2_SHAPES)
@pytest.mark.parametrize("core", ["rmw", "first"])
def test_k2_radix_core_models_match_the_plain_version_bitwise(rng, core, B, G, L):
    """K2's warp and block routes with the sort done by each ranking's
    model (positions as 16-bit payloads) give the plain version bitwise."""
    x = _segments(rng, B * G, L).reshape(B, G * L)
    r = _res(rng, B * G, L).reshape(B, G * L)
    np.testing.assert_array_equal(_bits(model_k2(x, r, L, core=core)), _bits(_plain_k2(x, r, L)))


@pytest.mark.parametrize("L", [16385, 32768, 55152])
@pytest.mark.parametrize("core", ["rmw", "first"])
def test_k2_staged_chunk_sort_core_matches_the_plain_version_bitwise(rng, core, L):
    """The staged route with each chunk sorted by each core's model (the
    default build's on 16 keys a lane, its slot written in slot order from
    the key buffer; the first core's stored member by member at tree slots), on tie runs
    across chunk boundaries with NaN among them, -0 and +0 in different
    chunks, all-NaN and all-equal segments: the plain version bitwise."""
    x, r = _data(rng, 4, 1, L, "long"), _res(rng, 4, L)
    np.testing.assert_array_equal(_bits(model_k2(x, r, L, core=core)), _bits(_plain_k2(x, r, L)))


# K1's warp route (L = 65 to 256): its edges and config 5's L = 240
CORE_K1_SHAPES = [(9, 1, 65), (4, 2, 240), (5, 2, 256)]


@pytest.mark.parametrize("B,G,L", CORE_K1_SHAPES)
@pytest.mark.parametrize("core", ["rmw", "first"])
def test_k1_radix_core_models_match_the_plain_version_bitwise(rng, core, B, G, L):
    """K1's warp route with the sort done by each ranking's model gives the
    plain version bitwise (NaN payloads, -NaN, +-0, ties, all-equal rows)."""
    x = _segments(rng, B * G, L).reshape(B, G * L)
    assert K.route("count_sort_segments", L) == "warp"
    np.testing.assert_array_equal(_bits(model_k1(x, L, core=core)), _bits(_plain_k1(x, L)))


def test_slot_member_inverts_tree_slot():
    """Writing slot s from member slot_member(s) of the sorted chunk lays
    the chunk out as storing member p at tree_slot(p) does."""
    assert np.array_equal(TREE_SLOT[SLOT_MEMBER], np.arange(K.CHUNK_SLOTS))
    assert _chunk_sort_layout(13788, "rmw") == (27, 16)
    assert _chunk_sort_layout(16384, "rmw") == (32, 16)  # at most 1,024 threads


# each core mutant and the (B, G, L) shapes it must fail at: a warp (config
# 9a's rows), a block, the staged route's chunk sort (1950-2100 daily)
CORE_K2_MUTANTS = {"lanes": [(5, 1, 730), (2, 1, 3650), (1, 1, 55152)],
                   "early_write": [(5, 1, 730), (2, 1, 3650), (1, 1, 55152)],
                   "stale_read": [(5, 1, 730), (2, 1, 3650), (1, 1, 55152)],
                   "warps": [(2, 1, 3650), (1, 1, 55152)], "skip": [(2, 1, 3650), (1, 1, 55152)]}


@pytest.mark.parametrize("core_mutation", sorted(CORE_K2_MUTANTS))
def test_k2_radix_core_mutants_disagree(rng, core_mutation):
    """An unstable rank (no lower lanes, no earlier warps, a counter written
    before its peers read it or read before the previous item's write) and
    a pass skipped where the first warp's chunk holds one digit each make
    K2's model disagree at every shape."""
    differs = []
    for B, G, L in CORE_K2_MUTANTS[core_mutation]:
        x = _data(rng, B, G, L, "gauss" if L > K.BLOCK_MAX else "segments")
        x[0, :1024] = 7.0  # a first warp's chunk of one key in a segment that varies
        r = _res(rng, B * G, L).reshape(B, G * L)
        got = model_k2(x, r, L, core="rmw", core_mutation=core_mutation)
        differs.append(not np.array_equal(_bits(got), _bits(_plain_k2(x, r, L))))
    assert all(differs), f"{core_mutation} agrees at {[s for s, d in zip(CORE_K2_MUTANTS[core_mutation], differs) if not d]}"
