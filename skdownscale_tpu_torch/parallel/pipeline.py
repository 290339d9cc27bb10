"""The production loop: zarr store -> device -> zarr store, double-buffered
on CUDA streams.

Port of ``skdownscale_tpu/parallel/pipeline.py`` with the same semantics:
the grid pair is read off the store in bands of whole leading spatial rows
(:class:`~.zarr_io.ZarrGridSource`), NaN cells are compacted out of each
band, the batched registry fits and predicts the band's valid cells on the
device over the store's own period, and the corrected band goes back to the
output store under NaN as one store object (:class:`ZarrChunkWriter`), with
a ``time`` member so that a DatetimeIndex round-trips.

On a CUDA device the stages overlap like this, band ``i`` in the middle:

* a worker thread (:func:`..utils.prefetch.prefetched`) reads band ``i+1``,
  compacts its valid cells straight into a pinned host slot (two slots, used
  in turn), issues the host-to-device copy with ``non_blocking=True`` on a
  side stream and records an event behind it;
* the main thread makes the compute stream wait on band ``i``'s event (a
  device-side wait), marks the copied tensors as used by that stream
  (``record_stream``, so that the caching allocator does not hand their
  memory out again while the copy could still be running), fits and
  predicts, and copies the output into a pinned slot behind another event;
* it then waits on that event and scatters band ``i`` under NaN, encodes it
  and puts it in the store, while the worker reads band ``i+1``.

The host waits only on those events.  A pinned input slot is written again
two bands later, after its copy's event has completed; the output slot is
written again only after the band in it was stored.  The store read and
write take nearly all of the wall and the device's fit and predict little
of it, so a band is written as soon as it is computed, and its write
overlaps the next band's read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import zarrlite
from ..utils.device import resolve
from ..utils.prefetch import prefetched
from .zarr_io import ZarrGridSource

__all__ = ["PipelineReport", "run_pointwise_pipeline"]


@dataclass
class PipelineReport:
    """Stage-split accounting for one pipeline run.

    ``read_s`` / ``pack_s`` / ``put_s`` accumulate on the prefetch worker
    (host clock: the store read and decode, the compaction into the staging
    slot, the issue of the host-to-device copy); ``device_s`` is the fit
    and predict of every band on the device (CUDA events; the host clock on
    the CPU) and ``write_s`` the scatter, encode and store put on the main
    thread.  ``overlap_s`` is the serial sum of the stages minus the wall.
    ``stages`` holds ``pinned`` (every staging slot page-locked) and the
    copies' device times, ``h2d_device_s`` and ``d2h_device_s`` (CUDA
    events, 0 on the CPU)."""

    n_cells: int = 0
    n_valid: int = 0
    n_chunks: int = 0
    wall_s: float = 0.0
    read_s: float = 0.0
    pack_s: float = 0.0
    put_s: float = 0.0
    device_s: float = 0.0
    write_s: float = 0.0
    checksum: float = 0.0  # sum of the corrected outputs, pad rows included
    stages: dict = field(default_factory=dict)

    @property
    def cells_per_sec(self) -> float:
        return self.n_cells / self.wall_s if self.wall_s else float("nan")

    @property
    def overlap_s(self) -> float:
        serial = self.read_s + self.pack_s + self.put_s + self.device_s + self.write_s
        return serial - self.wall_s

    def summary(self) -> str:
        return (
            f"{self.n_cells:,} cells ({self.n_valid:,} valid) in {self.wall_s:.2f}s "
            f"= {self.cells_per_sec:,.0f} cells/s | read {self.read_s:.2f}s "
            f"pack {self.pack_s:.2f}s h2d {self.put_s:.2f}s device {self.device_s:.2f}s "
            f"write {self.write_s:.2f}s (overlap hid {self.overlap_s:.2f}s)"
        )


def _row_aligned_chunks(n_cells: int, rest: int, cell_chunk: int):
    """Flat-cell spans aligned to whole leading spatial rows, so store reads
    and output chunks are both row bands on the store's own grid."""
    rows_per = max(cell_chunk // rest, 1)
    step = rows_per * rest
    return [(lo, min(lo + step, n_cells)) for lo in range(0, n_cells, step)], rows_per


class _Staging:
    """Two host input slots a variable, used in turn by successive bands,
    and one output slot: pinned on a CUDA run, so that the copies are
    asynchronous.  An input slot is written again only after the event of
    the copy that last read it completed."""

    def __init__(self, rows: int, T: int, pinned: bool):
        def slot():
            return torch.empty((rows, T), dtype=torch.float32, pin_memory=pinned)

        self.x = [slot(), slot()]
        self.y = [slot(), slot()]
        self.out = slot()
        self.copied = [None, None]  # the event behind each slot's last copy

    def pinned(self) -> bool:
        return all(t.is_pinned() for t in (*self.x, *self.y, self.out))


def _compact_into(dst: torch.Tensor, src: np.ndarray, ids: np.ndarray, n_pad: int) -> None:
    """Rows ``ids`` of ``src`` into the first rows of ``dst``, then
    ``n_pad`` copies of the last of them."""
    n = len(ids)
    buf = dst.numpy()
    np.take(src, ids, axis=0, out=buf[:n])
    if n_pad:
        buf[n : n + n_pad] = buf[n - 1]


def run_pointwise_pipeline(
    store_in,
    store_out,
    model=None,
    *,
    gcm_var: str = "gcm",
    obs_var: str = "obs",
    out_var: str = "corrected",
    cell_chunk: int = 131072,
    zarr_format: int = 3,
    compressor: str = "blosc",
    inner_chunks=None,
    checksum: bool = False,
    out_dtype=np.float32,
    pad_to: int | None = None,
    device="cuda",
) -> PipelineReport:
    """Read a (time, \\*spatial) GCM + obs grid pair from ``store_in``, fit
    and predict the model's batched implementation band by band on
    ``device``, and write the corrected grid to ``store_out``.

    ``store_in`` / ``store_out`` are paths or dict-like key->bytes mappings
    (:mod:`..utils.zarrlite`).  ``model`` defaults to
    ``BcsdTemperature(return_anoms=False)``; any estimator with a batched
    registry entry works, and it fits and predicts the store's own period.
    Bands hold whole leading spatial rows, at most ``cell_chunk`` cells
    (one row at least); each band is one object of the output store, or
    with ``inner_chunks`` (v3) one ``sharding_indexed`` shard of chunks of
    that shape, and ``checksum`` adds a verified crc32c to the chunk
    chain.  ``pad_to`` pads each band's valid cells up to a multiple by
    repeating the last valid cell (the pad rows are dropped from the
    output).  The grid is read and computed in float32.

    ``device`` is the card unless the caller passes ``"cpu"``; without a
    card a CUDA device raises.
    """
    from ..models import batched as _b

    dev = resolve(device, "run_pointwise_pipeline")
    cuda = dev.type == "cuda"
    if model is None:
        from ..models.bcsd import BcsdTemperature

        model = BcsdTemperature(return_anoms=False)
    if not _b.supports_batched(model):
        raise ValueError(f"{type(model).__name__} has no batched registry entry")

    rep = PipelineReport()
    t_wall = time.perf_counter()

    gcm = ZarrGridSource(store_in, gcm_var)
    obs = ZarrGridSource(store_in, obs_var)
    if gcm.spatial_shape != obs.spatial_shape or gcm.n_time != obs.n_time:
        raise ValueError(
            f"gcm {gcm.spatial_shape}x{gcm.n_time} and obs "
            f"{obs.spatial_shape}x{obs.n_time} grids do not align"
        )
    index = gcm.index
    T, C = gcm.n_time, gcm.n_cells
    spatial = gcm.spatial_shape
    rest = int(np.prod(spatial[1:])) if len(spatial) > 1 else 1
    spans, rows_per = _row_aligned_chunks(C, rest, cell_chunk)
    rep.n_cells = C
    rep.n_chunks = len(spans)

    out_store = zarrlite._as_store(store_out)
    if zarr_format == 3:
        zarrlite._put_json(
            out_store, "zarr.json",
            {"zarr_format": 3, "node_type": "group", "attributes": {}},
        )
    else:
        zarrlite._put_json(out_store, ".zgroup", {"zarr_format": 2})
    band = (T, rows_per, *spatial[1:])
    writer = zarrlite.ZarrChunkWriter(
        out_store,
        shape=(T, *spatial),
        dtype=np.dtype(out_dtype),
        chunks=tuple(inner_chunks) if inner_chunks is not None else band,
        shards=band if inner_chunks is not None else None,
        compressor=compressor,
        zarr_format=zarr_format,
        prefix=out_var,
        checksum=checksum,
    )
    # time member so the output round-trips its DatetimeIndex
    import pandas as pd

    if isinstance(index, pd.DatetimeIndex):
        tvals = np.asarray(index, dtype="datetime64[ns]").view(np.int64)
        tattrs = {"kind": "datetime64[ns]"}
    else:
        tvals, tattrs = np.asarray(index), None
    zarrlite.save_array(
        out_store, tvals, prefix="time", zarr_format=zarr_format, attrs=tattrs
    )

    band_cells = rows_per * rest
    stage = _Staging(band_cells + (pad_to - 1 if pad_to else 0), T, pinned=cuda)
    rep.stages["pinned"] = stage.pinned()
    rep.stages["h2d_device_s"] = rep.stages["d2h_device_s"] = 0.0
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    compute_stream = torch.cuda.Stream(dev) if cuda else None

    def timing_event():
        return torch.cuda.Event(enable_timing=True)

    def prep(item):
        k, (lo, hi) = item
        s = k % 2
        t0 = time.perf_counter()
        xc = gcm.read_cells(lo, hi, dtype=np.float32)  # (n, T) contiguous
        yc = obs.read_cells(lo, hi, dtype=np.float32)
        t1 = time.perf_counter()
        rep.read_s += t1 - t0
        ids = np.nonzero(np.isfinite(xc[:, 0]))[0]
        n_pad = pad_to - len(ids) % pad_to if pad_to and len(ids) % pad_to and len(ids) else 0
        n = len(ids) + n_pad
        if stage.copied[s] is not None:
            stage.copied[s].synchronize()  # the slot's last copy has read it
        if n:
            _compact_into(stage.x[s], xc, ids, n_pad)
            _compact_into(stage.y[s], yc, ids, n_pad)
        t2 = time.perf_counter()
        rep.pack_s += t2 - t1
        if not cuda:  # band k is computed before prep(k + 2) reuses its slot
            xd, yd, copied = stage.x[s][:n], stage.y[s][:n], None
        else:
            with torch.cuda.stream(copy_stream):
                start, copied = timing_event(), timing_event()
                start.record(copy_stream)
                xd = stage.x[s][:n].to(dev, non_blocking=True)
                yd = stage.y[s][:n].to(dev, non_blocking=True)
                copied.record(copy_stream)
            stage.copied[s] = copied
            copied = (start, copied)
        rep.put_s += time.perf_counter() - t2
        return k, (lo, hi), ids, xd, yd, copied

    def compute(xd, yd, copied):
        """Fit and predict one band; returns what its write needs."""
        if not cuda:
            t0 = time.perf_counter()
            state = _b.batched_fit(model, index, xd[..., None], yd)
            out = _b.batched_predict(model, state, index, xd[..., None], index)
            rep.device_s += time.perf_counter() - t0
            return out.numpy(), None
        with torch.cuda.stream(compute_stream):
            compute_stream.wait_event(copied[1])
            xd.record_stream(compute_stream)
            yd.record_stream(compute_stream)
            ev = [timing_event() for _ in range(3)]
            ev[0].record(compute_stream)
            state = _b.batched_fit(model, index, xd[..., None], yd)
            out = _b.batched_predict(model, state, index, xd[..., None], index)
            ev[1].record(compute_stream)
            host = stage.out[: out.shape[0]]
            host.copy_(out, non_blocking=True)
            ev[2].record(compute_stream)
            del state, out
        return host, (copied, ev)

    def write(span, ids, out, events):
        lo, hi = span
        if events is not None:  # the wait is the band's device work, not the write's
            (h2d_start, h2d_end), ev = events
            ev[2].synchronize()
            rep.device_s += ev[0].elapsed_time(ev[1]) / 1e3
            rep.stages["d2h_device_s"] += ev[1].elapsed_time(ev[2]) / 1e3
            rep.stages["h2d_device_s"] += h2d_start.elapsed_time(h2d_end) / 1e3
            out = out.numpy()
        t0 = time.perf_counter()
        rep.checksum += float(np.nansum(out, dtype=np.float64))
        full = np.full((hi - lo, T), np.nan, out_dtype)
        full[ids] = out[: len(ids)]  # drop pad_to rows
        blk = full.T.reshape(T, (hi - lo) // rest, *spatial[1:])
        writer.write_chunk((0, lo // band_cells) + (0,) * (len(spatial) - 1), blk)
        rep.write_s += time.perf_counter() - t0
        rep.n_valid += len(ids)

    for _, span, ids, xd, yd, copied in prefetched(list(enumerate(spans)), prep):
        if len(ids):
            out, events = compute(xd, yd, copied)
        else:
            out, events = np.empty((0, T), np.float32), None
        del xd, yd
        write(span, ids, out, events)

    rep.wall_s = time.perf_counter() - t_wall
    return rep
