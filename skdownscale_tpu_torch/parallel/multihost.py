"""Multi-process input feeding: each process places only its slice.

Port of ``skdownscale_tpu/parallel/multihost.py``.  In a job of several
processes (``torch.distributed``), each process holds only its contiguous
slice of the grid's cell axis and places it on its own devices; the shards
of the global mesh together are the whole (padded) grid, as
``jax.make_array_from_process_local_data`` assembles it.  The per-cell
compute involves no collective at all.  In one process the local data is
the global data and :func:`feed_cells` is :func:`~.mesh.shard_cells`.

The several-process branch runs for real in
``tests/test_torch_multiprocess.py``: two processes join a gloo group on
localhost through :mod:`.dryrun`, each feeds its :func:`host_cell_slice`
of a zarr store, and the reassembled BCSD output is bitwise equal to the
one-process run of the same 8-shard mesh.
"""

from __future__ import annotations

import numpy as np

from .mesh import CellMesh, ShardedCells, shard_cells, to_shard

__all__ = ["host_cell_slice", "feed_cells"]


def host_cell_slice(n_cells: int, mesh: CellMesh) -> slice:
    """The ``[start, stop)`` range of the (padded) global cell axis this
    process provides: its shards' rows, contiguous.  The process index and
    count are the mesh group's (``torch.distributed``), 0 and 1 without
    one."""
    n_padded = n_cells + ((-n_cells) % mesh.size)
    per_proc = n_padded // mesh.world
    i = mesh.rank
    return slice(i * per_proc, min((i + 1) * per_proc, n_padded))


def feed_cells(local_cells: np.ndarray, n_cells_global: int, mesh: CellMesh):
    """``(ShardedCells, n_cells_global)`` from this process's contiguous
    slice of the cell axis (``local_cells``: its rows, host numpy; on the
    last process they may include the NaN padding rows).  The global
    array has the padded cell count; callers slice results back with
    ``n_cells_global``."""
    if mesh.world == 1:
        return shard_cells(local_cells, mesh)[0], n_cells_global
    n_padded = n_cells_global + ((-n_cells_global) % mesh.size)
    rows = n_padded // mesh.size
    want = rows * len(mesh.devices)
    if local_cells.shape[0] != want:
        raise ValueError(
            f"process {mesh.rank} passed {local_cells.shape[0]} cells; its slice "
            f"{host_cell_slice(n_cells_global, mesh)} holds {want}"
        )
    shards = [to_shard(local_cells[i * rows:(i + 1) * rows], dev) for i, dev in enumerate(mesh.devices)]
    return ShardedCells(mesh, shards, (n_padded, *local_cells.shape[1:])), n_cells_global
