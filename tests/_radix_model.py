"""A numpy model of the stable LSD radix sort of ``csrc/radix_sort.cuh``
that the row sort K9 (``csrc/sort_rows.cu``) and the rank-map K2
(``csrc/rank_map.cu``) run, shared by ``tests/test_torch_sort.py`` and
``tests/test_torch_rank_map_model.py``.

It follows the kernels' steps rather than their result.  A row's keys are
cut into blocks (one, or the 2 to 4 blocks of a cluster), each block walks
its elements in tiles of ``warps * items * 32``, and a warp holds a
contiguous chunk of a tile, item ``i`` of lane ``l`` being element
``i * 32 + l`` of its chunk.  A pass of 8-bit digits, low digit first:

* each warp ranks its items by digit (:func:`warp_ranks`), item by item:
  the lanes of one digit (the peers) are found, and each lane's rank is
  the warp's count of its digit in the items before (its counter's old
  count) plus its peers on lower lanes.  The default build reads and
  writes back: every lane reads its counter, then the lowest peer writes
  it advanced by the peers' number.  The first core's ranking (the trial
  build SDT_RADIX_CORE_PR6=1) has the lowest peer add the number atomically and
  broadcast the old count.  Either way the count travels in the 16-bit low
  half of the item's payload;
* a tile's counts turn into each warp's base per digit by an exclusive
  scan in (digit, warp) order (:func:`digit_warp_bases`: the scan within
  each group of 32 digits, plus the sums of the groups before), or, where a
  block walks several tiles or a cluster shares a row, into running places
  that start at the row's digit starts (and the blocks before, on a
  cluster) and advance by each tile's counts;
* each item goes to its place, with its position as a 16-bit payload
  (32-bit on the device-memory route);
* a pass whose byte is the same in every key of the row is skipped.

Mutants (``mutation``) that must make a sort disagree with the plain
stable sort: ``"lanes"`` (a rank leaves out the peers on lower lanes),
``"warps"`` (a base leaves out the earlier warps' items of the digit),
``"early_write"`` (the lowest peer writes before its peers read: the
first __syncwarp of an item dropped), ``"stale_read"`` (an item reads the
counters before the previous item's writes: the second one dropped),
``"skip"`` (a pass skipped where the first warp's chunk holds one digit,
though the row's varies), and a rank field or position payload narrower
than the longest warp column or row needs (``rank_bits``, ``pos_bits``).
Numpy only.
"""

import numpy as np

LANES = 32
BUCKETS = 256
SHIFTS = (0, 8, 16, 24)
RANK_BITS = 16  # the low half of a payload holds a warp's counts and ranks
POS_BITS = 16  # the high half holds the position, but on the device-memory route
_BELOW = np.tri(LANES, k=-1, dtype=bool)  # _BELOW[l, m]: lane m is below lane l


def ordered_ukeys(x):
    """``ordered_ukey`` of float32 ``x``: the order-isomorphic int32 key
    with its sign bit flipped, as uint32."""
    b = np.asarray(x, np.float32).view(np.int32)
    k = np.where(b >= 0, b, np.invert(b) ^ np.int32(-(2**31)))
    return k.view(np.uint32) ^ np.uint32(0x80000000)


def from_ukeys(u):
    """float32 of keys :func:`ordered_ukeys` made."""
    k = (np.asarray(u, np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    return np.where(k >= 0, k, np.invert(k ^ np.int32(-(2**31)))).view(np.float32)


def warp_ranks(d, valid, ranking, mutation=None, rank_bits=RANK_BITS):
    """``(counts, rank)`` of ``W`` warps' chunks: ``d`` (W, items, 32)
    digits, ``valid`` (W, items, 32) False past a chunk; ``counts`` (W, 256)
    each warp's count of each digit, ``rank`` (W, items, 32) each item's
    rank among its warp's items of its digit before it in (i, l) order, as
    ``ranking`` computes it item by item: ``"rmw"`` (every lane reads its
    digit's counter, then the lowest peer writes it back advanced by the
    peers) or ``"atomic"`` (the first core's: the lowest peer's atomic add, whose old
    count it broadcasts)."""
    W, items, _ = d.shape
    counts = np.zeros((W, BUCKETS), np.int64)
    prev = counts.copy()  # the counters before the last item's writes
    rank = np.zeros((W, items, LANES), np.int64)
    mask = (1 << rank_bits) - 1
    rows = np.broadcast_to(np.arange(W)[:, None], (W, LANES))
    for i in range(items):
        di = d[:, i]
        peers = (di[:, :, None] == di[:, None, :]) & valid[:, i, :, None] & valid[:, i, None, :]
        lower = np.sum(peers & _BELOW, axis=2)
        lead = valid[:, i] & (lower == 0)  # the lowest peer
        if ranking == "rmw":
            before = (prev if mutation == "stale_read" else counts)[rows, di]  # every lane's read
            prev = counts.copy()
            np.add.at(counts, (rows[lead], di[lead]), peers.sum(axis=2)[lead])  # the lowest peers' writes
            if mutation == "early_write":  # the other peers read after the write
                before = np.where(lower > 0, counts[rows, di], before)
        else:
            old = counts[rows, di]
            np.add.at(counts, (rows[lead], di[lead]), peers.sum(axis=2)[lead])
            before = np.take_along_axis(old, np.argmax(peers, axis=2), axis=1)  # the lowest peer's
        rank[:, i] = (before + (0 if mutation == "lanes" else lower)) & mask
    return counts, rank


def digit_warp_bases(counts, mutation=None):
    """Each warp's base per digit for one tile: the exclusive scan of
    ``counts`` (W, 256) in (digit, warp) order, taken as the kernels take it:
    thread d's scan within its group of 32 digits, the sums of the groups
    before, and the warps before."""
    total = counts.sum(0).reshape(8, 32)
    incl = np.cumsum(total, axis=1)
    group_sum = incl[:, -1]
    digit_base = (incl - total + (np.cumsum(group_sum) - group_sum)[:, None]).reshape(BUCKETS)
    warps = np.zeros_like(counts) if mutation == "warps" else np.cumsum(counts, axis=0) - counts
    return digit_base[None, :] + warps


def lsd_sort(keys, blocks, warps, items, ranking, with_positions=True, mutation=None,
             rank_bits=RANK_BITS, pos_bits=POS_BITS):
    """``(sorted keys, positions)`` of one row of uint32 ``keys`` sorted by
    ``blocks`` blocks (contiguous ranges of ``ceil(L / blocks)`` elements),
    each walking its range in tiles of ``warps * items * 32``, with
    ``ranking`` (:func:`warp_ranks`).  A block of one tile takes its
    places from the tile's counts; a block of several tiles, or a cluster's
    block, from the row's digit starts (and the blocks before it)."""
    L = keys.size
    key = keys.astype(np.uint32).copy()
    pos = np.arange(L, dtype=np.int64)
    tile = warps * items * LANES
    m = -(-L // blocks)
    bounds = [(r * m, min(L, r * m + m)) for r in range(blocks)]
    assert all(lo < hi for lo, hi in bounds)
    one_tile = blocks == 1 and L <= tile
    assert blocks == 1 or m <= tile  # a cluster's block holds one tile
    head = key[: items * LANES] if mutation == "skip" else key
    varying = int(np.bitwise_and.reduce(head) ^ np.bitwise_or.reduce(head))
    for shift in SHIFTS:
        if not (varying >> shift) & 0xFF:
            continue  # one digit holds the row: the order is kept
        dig = ((key >> shift) & 0xFF).astype(np.int64)
        total = np.bincount(dig, minlength=BUCKETS)
        start = np.cumsum(total) - total  # the row's digit starts
        before = np.zeros(BUCKETS, np.int64)  # the blocks before, on a cluster
        dst_k, dst_p = np.zeros_like(key), np.zeros_like(pos)  # a mutant may leave places unset
        written = np.zeros(L, np.int64)
        for lo, hi in bounds:
            run = start + before
            before = before + np.bincount(dig[lo:hi], minlength=BUCKETS)
            for t0 in range(lo, hi, tile):
                n = min(tile, hi - t0)
                dt = np.zeros(warps * items * LANES, np.int64)
                dt[:n] = dig[t0 : t0 + n]
                valid = np.arange(warps * items * LANES) < n
                counts, rank = warp_ranks(dt.reshape(warps, items, LANES), valid.reshape(warps, items, LANES),
                                          ranking, mutation, rank_bits)
                if one_tile:
                    base = digit_warp_bases(counts, mutation)
                else:
                    warp_prefix = np.zeros_like(counts) if mutation == "warps" else np.cumsum(counts, axis=0) - counts
                    base = run[None, :] + warp_prefix
                    run = run + counts.sum(0)
                w = np.repeat(np.arange(warps), items * LANES)[:n]
                place = np.clip(base[w, dt[:n]] + rank.reshape(-1)[:n], 0, L - 1)  # a mutant's may stray
                dst_k[place] = key[t0 : t0 + n]
                dst_p[place] = pos[t0 : t0 + n]
                np.add.at(written, place, 1)
        assert np.array_equal(written, np.ones(L)) or mutation or rank_bits < RANK_BITS
        key, pos = dst_k, dst_p & ((1 << pos_bits) - 1)
    return key, (pos if with_positions else None)
