"""K2, the rank map of ``csrc/rank_map.cu`` (``kernels/rank_map.py``
``rank_map_segments``): each query ranked in its segment of ``L`` and the
rank's entry of ``res`` written out.  One launch on ``rows`` segments reads
the queries and ``res`` and writes the output, 4 bytes each an element; it
does no float arithmetic.  Its functions on the warp, block and staged
routes (the packed route's ``packed_kernel`` is shared with K1 and runs
only at L <= 256)."""

NAMES = frozenset({"rank_map_warp_kernel", "rank_map_block_kernel", "sort_chunks_kernel",
                   "staged_search_kernel", "search_kernel"})
LAUNCH = {
    ("skdownscale_tpu_torch.kernels.rank_map", "launch_rank_map"):
        lambda lib, xq, res, L: {"rows": xq.numel() // L, "L": L},
}


def cost(rows: int, L: int) -> tuple[float, float]:
    n = rows * L
    return 0.0, 12.0 * n
