"""Cell meshes: the cell axis of a grid split over devices and processes.

Port of ``skdownscale_tpu/parallel/mesh.py``.  The JAX package places one
global array over a ``Mesh`` with a ``NamedSharding`` and lets XLA partition
the cell-local program; PyTorch has neither, so the port holds the pieces
itself:

* :class:`CellMesh` names this process's devices in mesh order, the
  ``torch.distributed`` process group that joins the processes of a job
  (``None`` for one process), the axis names and the global shard count
  ``size`` (processes x local devices).  Global shard ``k`` lives on rank
  ``k // len(devices)``.  A device may appear more than once: a mesh of
  ``[cuda:0] * 4`` is four shards on one card, run one after another, and
  ``["cpu"] * 8`` stands in for the JAX package's 8 virtual CPU devices.
* :func:`shard_cells` pads the cell axis with NaN rows to a multiple of the
  mesh size and splits it into contiguous equal blocks in mesh order, the
  split ``device_put`` makes; a :class:`ShardedCells` holds this process's
  blocks, each on its device, and the global shape.
* :func:`map_shards` runs a function on every local shard, issuing each
  shard's work before any host wait: on distinct cards the shards run at
  the same time.
* Two collectives, :func:`all_gather` and :func:`all_reduce`: across the
  local shards they are copies to the first local device and sums in mesh
  order; across processes they run on the mesh's group.  NCCL refuses two
  ranks on one card, so under gloo the tensors are staged through host
  memory.  They are kilobytes (a quantile sketch, the (f+1)^2 sums of a
  linear fit); the computation stays on the devices.  :func:`all_reduce`
  adds every shard's part in mesh order whatever the number of processes,
  so a job of one process and one of several give the same bits.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "CellMesh",
    "MeshSharding",
    "ShardedCells",
    "all_gather",
    "all_reduce",
    "as_mesh",
    "cell_mesh",
    "cell_sharding",
    "gather_objects",
    "map_shards",
    "on_device",
    "pad_to_multiple",
    "shard_cells",
    "split_sizes",
]

CELL_AXIS = "cells"


class CellMesh:
    """This process's devices of a mesh over the cell axis (and, for a
    :func:`~.timeshard.time_cell_mesh`, the time axis).

    ``shape`` maps each axis name to its size, as a JAX ``Mesh.shape``
    does; ``size`` is the product, every process's devices together.
    """

    def __init__(self, devices, axis_names=(CELL_AXIS,), group=None, shape=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.axis_names = tuple(axis_names)
        if group is None:
            self.rank, self.world = 0, 1
        else:
            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
        self.size = self.world * len(self.devices)
        shape = tuple(shape) if shape is not None else (self.size,)
        if len(shape) != len(self.axis_names) or int(np.prod(shape)) != self.size:
            raise ValueError(f"mesh shape {shape} does not hold {self.size} shards on axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, shape))

    @property
    def local_shards(self) -> range:
        """Global indices of this process's shards, in mesh order."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    def __repr__(self):
        return (f"CellMesh(devices={[str(d) for d in self.devices]}, axis_names={self.axis_names}, "
                f"shape={self.shape}, processes={self.world})")


class MeshSharding(NamedTuple):
    """A mesh and which of its axes splits each array axis (``None``:
    whole): the port's ``NamedSharding(mesh, P(...))``."""

    mesh: CellMesh
    spec: tuple


def cell_mesh(devices=None, axis_name: str = CELL_AXIS, group=None) -> CellMesh:
    """1-D mesh over this process's ``devices`` (every CUDA device of the
    process by default; there is no CPU default).  ``group`` joins the
    processes of a job: the default group when ``torch.distributed`` is
    initialised, else none.  Each process of a job passes the same number
    of devices."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "cell_mesh() takes every CUDA device of the process, and there is none; "
                "pass devices= (e.g. ['cpu'] * 8) for a mesh of CPU shards"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return CellMesh(devices, (axis_name,), group)


def as_mesh(sharding) -> CellMesh:
    """The mesh of a :class:`CellMesh` or a :class:`MeshSharding`."""
    if isinstance(sharding, CellMesh):
        return sharding
    if isinstance(sharding, MeshSharding):
        return sharding.mesh
    raise TypeError(f"expected a CellMesh or a MeshSharding, got {type(sharding).__name__}")


def cell_sharding(mesh: CellMesh, ndim: int = 1, axis_name: str | None = None) -> MeshSharding:
    """The leading (cell) axis of an ``ndim``-array split over the mesh."""
    axis = axis_name or mesh.axis_names[0]
    return MeshSharding(mesh, (axis, *([None] * (ndim - 1))))


def pad_to_multiple(arr, multiple: int, axis: int = 0, fill=np.nan):
    """Pad ``axis`` up to a multiple (sharding needs even divisibility);
    returns the padded array and the original length."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, rem)
    return np.pad(arr, widths, constant_values=fill), n


def split_sizes(n: int, parts: int) -> list[int]:
    """Rows of each of ``parts`` shards when ``n`` rows split unevenly:
    ``ceil(n / parts)`` a shard, the last shards short or empty."""
    per = -(-n // parts) if parts else 0
    return [max(0, min(per, n - k * per)) for k in range(parts)]


def on_device(device: torch.device):
    """The context that makes ``device`` current for launches (CUDA only)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def to_shard(block: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host block on its shard's device: float32 on a CUDA device, its own
    dtype elsewhere."""
    t = torch.from_numpy(np.ascontiguousarray(block))
    if device.type == "cuda" and t.is_floating_point():
        t = t.float()
    return t.to(device)


class ShardedCells:
    """This process's blocks of a cell-sharded ``(C, ...)`` array.

    ``shards[i]`` is local shard ``i`` (global shard
    ``mesh.local_shards[i]``) on ``mesh.devices[i]``; every shard has
    ``shape[0] // mesh.size`` rows.  ``shape`` is the global (padded) shape.
    """

    def __init__(self, mesh: CellMesh, shards, shape):
        self.mesh = mesh
        self.shards = list(shards)
        self.shape = tuple(shape)
        if len(self.shards) != len(mesh.devices):
            raise ValueError(f"{len(self.shards)} shards for {len(mesh.devices)} local devices")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def map(self, fn, *others) -> ShardedCells:
        """``fn`` of each shard (and the matching shards of ``others``) as
        a new ShardedCells of the same mesh."""
        out = map_shards(fn, self, *others)
        return ShardedCells(self.mesh, out, (self.mesh.size * out[0].shape[0], *out[0].shape[1:]))

    def gather(self, device=None):
        """The whole array: host numpy, or a tensor on ``device``."""
        if device is None:
            local = [s.cpu().numpy() for s in self.shards]
            return np.concatenate([b for part in gather_objects(local, self.mesh) for b in part])
        dev = torch.device(device)
        if self.mesh.world == 1:
            return torch.cat([s.to(dev) for s in self.shards])
        return all_gather(self.shards, self.mesh).to(dev).flatten(0, 1)

    def __repr__(self):
        return f"ShardedCells(shape={self.shape}, dtype={self.dtype}, mesh={self.mesh!r})"


def shard_cells(arr, mesh: CellMesh):
    """``(ShardedCells, n)``: ``arr``'s leading (cell) axis padded with NaN
    rows to a multiple of the mesh size and split over the mesh (float32 on
    a CUDA device); ``n`` is the unpadded cell count."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    padded, n = pad_to_multiple(np.asarray(arr), mesh.size, axis=0)
    rows = padded.shape[0] // mesh.size
    shards = [to_shard(padded[k * rows:(k + 1) * rows], dev)
              for k, dev in zip(mesh.local_shards, mesh.devices)]
    return ShardedCells(mesh, shards, padded.shape), n


def map_shards(fn, *arrays) -> list:
    """``fn`` on every local shard, in mesh order: a :class:`ShardedCells`
    argument passes its shard, any other argument passes whole.  Each
    shard's work is issued with its device current and nothing waits for
    the host in between."""
    mesh = next(a.mesh for a in arrays if isinstance(a, ShardedCells))
    out = []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev):
            out.append(fn(*(a.shards[i] if isinstance(a, ShardedCells) else a for a in arrays)))
    return out


def _staged(group) -> bool:
    """Whether the group's backend takes host tensors only (gloo)."""
    return dist.get_backend(group) == "gloo"


def all_gather(parts, mesh: CellMesh) -> torch.Tensor:
    """Every shard's part (this process's ``parts``, one a local shard, all
    of one shape) stacked in mesh order: ``(mesh.size, *shape)`` on the
    first local device."""
    dev = mesh.devices[0]
    local = torch.stack([p.to(dev) for p in parts])
    if mesh.world == 1:
        return local
    send = local.cpu() if local.is_cuda and _staged(mesh.group) else local
    recv = [torch.empty_like(send) for _ in range(mesh.world)]
    dist.all_gather(recv, send.contiguous(), group=mesh.group)
    return torch.cat(recv).to(dev)


def all_reduce(parts, mesh: CellMesh) -> torch.Tensor:
    """The sum of every shard's part, added in mesh order on the first
    local device."""
    g = all_gather(parts, mesh)
    total = g[0].clone()
    for t in g[1:]:
        total += t
    return total


def gather_objects(obj, mesh: CellMesh) -> list:
    """Every process's ``obj`` (host data: arrays, trees of them), by rank."""
    if mesh.world == 1:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out
