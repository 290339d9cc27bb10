"""The port's device layer: cell meshes over devices and processes
(``mesh``, ``multihost``, ``timeshard``), the zarr cell-range reader and
its per-process feed (``zarr_io``), the store -> device -> store pipeline
(``pipeline.run_pointwise_pipeline``) and a multi-process dry run
(``python -m skdownscale_tpu_torch.parallel.dryrun``)."""

from .mesh import cell_mesh, cell_sharding, pad_to_multiple, shard_cells
from .multihost import feed_cells, host_cell_slice
from .timeshard import shard_cells_time, time_cell_mesh, time_sharding
from .zarr_io import ZarrGridSource, feed_zarr_cells

__all__ = [
    "cell_mesh",
    "cell_sharding",
    "pad_to_multiple",
    "shard_cells",
    "feed_cells",
    "host_cell_slice",
    "time_cell_mesh",
    "time_sharding",
    "shard_cells_time",
    "ZarrGridSource",
    "feed_zarr_cells",
]
