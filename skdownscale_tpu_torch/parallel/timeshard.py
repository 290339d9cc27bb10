"""Time-axis sharding for very long per-cell records.

Port of ``skdownscale_tpu/parallel/timeshard.py``.  A 2-D ``(cells, time)``
mesh holds each cell row's record split over ``time_shards`` devices, so a
device holds ``C/n_cell_shards x T/n_time_shards`` of the input: the
per-device input that bounds how long a record can be loaded.

The JAX package leaves the rest to GSPMD, which keeps elementwise stages
sharded on both axes and inserts an all-gather of each cell row's time
shards where a row sort or a grouped gather needs the whole series.  The
port makes that collective explicit: :meth:`TimeShardedCells.gather_rows`
gathers each cell row's time shards onto the row's first device, and the
full-row stages (fit, predict) run there, cell-parallel over the rows
(:func:`~.mesh.map_shards`).  So the port bounds each device's input, and
not its state or its full-row working set: fitted state lives per cell row
on the row's first device, where GSPMD could keep time-length state
(stored CDF values) split over both axes.

A cell row never spans processes: each process's device count is a
multiple of ``time_shards``.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import (
    CELL_AXIS,
    CellMesh,
    MeshSharding,
    ShardedCells,
    cell_mesh,
    gather_objects,
    pad_to_multiple,
    to_shard,
)

__all__ = ["TimeShardedCells", "time_cell_mesh", "time_sharding", "shard_cells_time"]

TIME_AXIS = "time"


def time_cell_mesh(devices=None, time_shards: int = 2, cell_axis: str = CELL_AXIS,
                   time_axis: str = TIME_AXIS) -> CellMesh:
    """2-D mesh: ``size / time_shards`` cell rows x ``time_shards``; global
    shard ``k`` is cell row ``k // time_shards``, time shard
    ``k % time_shards`` (time on the minor axis, as in the JAX package)."""
    flat = cell_mesh(devices)
    if flat.size % time_shards:
        raise ValueError(f"{flat.size} devices not divisible by time_shards={time_shards}")
    if len(flat.devices) % time_shards:
        raise ValueError(
            f"each process's {len(flat.devices)} devices must hold whole cell rows of "
            f"{time_shards} time shards"
        )
    return CellMesh(flat.devices, (cell_axis, time_axis), flat.group,
                    (flat.size // time_shards, time_shards))


def time_sharding(mesh: CellMesh, ndim: int = 2) -> MeshSharding:
    """Axis 0 split over the cell rows, axis 1 over the time shards."""
    cell_axis, time_axis = mesh.axis_names[:2]
    return MeshSharding(mesh, (cell_axis, time_axis, *([None] * (ndim - 2))))


class TimeShardedCells:
    """This process's ``(C/nc, T/nt, ...)`` blocks of a ``(C, T, ...)``
    array on a ``(cells, time)`` mesh, in mesh order; ``shape`` is the
    global (cell-padded) shape."""

    def __init__(self, mesh: CellMesh, blocks, shape):
        self.mesh = mesh
        self.blocks = list(blocks)
        self.shape = tuple(shape)

    def row_mesh(self) -> CellMesh:
        """The 1-D mesh of the cell rows: each local row's first device."""
        nt = self.mesh.shape[self.mesh.axis_names[1]]
        return CellMesh(self.mesh.devices[::nt], (self.mesh.axis_names[0],), self.mesh.group)

    def gather_rows(self) -> ShardedCells:
        """Each cell row's time shards gathered onto the row's first device
        (the all-gather GSPMD inserts before a full-row stage): a
        :class:`ShardedCells` of whole records over :meth:`row_mesh`."""
        nt = self.mesh.shape[self.mesh.axis_names[1]]
        rows = [torch.cat([b.to(self.blocks[r].device) for b in self.blocks[r:r + nt]], dim=1)
                for r in range(0, len(self.blocks), nt)]
        return ShardedCells(self.row_mesh(), rows, self.shape)

    def gather(self) -> np.ndarray:
        """The whole array on the host."""
        nt = self.mesh.shape[self.mesh.axis_names[1]]
        local = [b.cpu().numpy() for b in self.blocks]
        blocks = [b for part in gather_objects(local, self.mesh) for b in part]
        return np.concatenate([np.concatenate(blocks[r:r + nt], axis=1)
                               for r in range(0, len(blocks), nt)])


def shard_cells_time(arr, mesh: CellMesh):
    """``(TimeShardedCells, n)``: ``(cells, time, ...)`` data split over
    both mesh axes.  The cell axis is padded with NaN rows to the cell-row
    count; the time axis must divide the time shards already (padding it
    would change quantile and rolling semantics: feed whole series)."""
    nc, nt = mesh.shape.values()
    if arr.shape[1] % nt:
        raise ValueError(f"time length {arr.shape[1]} not divisible by the mesh's {nt} time shards")
    padded, n = pad_to_multiple(np.asarray(arr), nc, axis=0)
    rows, cols = padded.shape[0] // nc, padded.shape[1] // nt
    blocks = []
    for k, dev in zip(mesh.local_shards, mesh.devices):
        r, t = divmod(k, nt)
        blocks.append(to_shard(padded[r * rows:(r + 1) * rows, t * cols:(t + 1) * cols], dev))
    return TimeShardedCells(mesh, blocks, padded.shape), n
