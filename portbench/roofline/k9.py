"""K9, the row sort of ``csrc/sort_rows.cu`` (``kernels/sort_rows.py``) in
its three forms: ``sort`` reads a row and writes it sorted (8 bytes an
element), ``sort_positions`` also writes each element's int32 position
(12), ``unsort`` reads values and positions and writes the values back in
order (12).  No float arithmetic.  Its functions on every route."""

NAMES = frozenset({"sort_rows_warp_kernel", "sort_rows_block_kernel", "sort_rows_smem_kernel",
                   "sort_rows_long_kernel", "unsort_rows_kernel", "unsort_rows_warp_kernel",
                   "unsort_rows_scatter_kernel"})
LAUNCH = {
    ("skdownscale_tpu_torch.kernels.sort_rows", "launch_sort"):
        lambda lib, x, with_positions: {"form": "sort_positions" if with_positions else "sort",
                                        "rows": x.shape[0], "L": x.shape[1]},
    ("skdownscale_tpu_torch.kernels.sort_rows", "launch_unsort"):
        lambda lib, vals, pos: {"form": "unsort", "rows": vals.shape[0], "L": vals.shape[1]},
}
BYTES = {"sort": 8.0, "sort_positions": 12.0, "unsort": 12.0}


def cost(form: str, rows: int, L: int) -> tuple[float, float]:
    return 0.0, BYTES[form] * rows * L
