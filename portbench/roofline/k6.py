"""K6, the row-batched table interpolation of ``csrc/interp.cu``
(``kernels/interp.py`` ``batched_interp``): ``table_rows`` tables of ``L``
knots (``xp``, ``fp``; 1 where every row shares one) and ``query_rows``
rows of ``Q`` queries (1 where shared), the larger of the two the rows of
the output.  One launch reads the tables and the queries and writes one
value a query, 4 bytes each; a query's value takes a subtraction, a
division, a multiplication and an addition (4 operations)."""

NAMES = frozenset({"batched_interp_global_kernel", "batched_interp_staged_kernel", "long_row_nan_kernel",
                   "long_row_search_kernel"})
LAUNCH = {
    ("skdownscale_tpu_torch.kernels.interp", "launch"):
        lambda lib, xp, fp, q: {"table_rows": xp.shape[0], "query_rows": q.shape[0], "L": xp.shape[1],
                                "Q": q.shape[1]},
}


def cost(table_rows: int, query_rows: int, L: int, Q: int) -> tuple[float, float]:
    rows = max(table_rows, query_rows)
    return 4.0 * rows * Q, 4.0 * (2 * table_rows * L + query_rows * Q + rows * Q)
