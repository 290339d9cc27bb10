"""A multi-process dry run of the cell mesh: one process of a job.

Counterpart of the JAX package's ``tests/_mp_worker.py`` and of
``dryrun_multichip`` (``__graft_entry__.py``).  Each of ``nprocs``
processes joins a ``torch.distributed`` gloo group by TCP on localhost
(none for one process), builds the global mesh of ``shards`` shards
(``shards / nprocs`` of them on its ``device``), feeds its slice of a zarr
store's ``gcm`` and ``obs`` members through ``feed_zarr_cells``, runs the
dense BCSD fit + predict on each of its shards, fits the pooled quantile
sketch of ``gcm`` over the mesh and writes its output shards and the ladder
to ``OUTDIR`` (:func:`dry_run` is that work, for a run in the caller's
process)::

    python -m skdownscale_tpu_torch.parallel.dryrun RANK NPROCS PORT STORE OUTDIR \\
        [--device cpu|cuda] [--shards 8] [--sample-per-shard 8192] [--quantiles 2048]

A mesh of repeated devices shares one card (``--device cuda``: two
processes of 4 shards each on ``cuda:0``); gloo stages the sketch through
host memory.  :func:`run_job` starts a whole job as subprocesses and
:func:`assemble` reads its output back; the tests and ``chip_smoke.py``
use both.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

__all__ = ["dry_run", "main", "run_job", "assemble"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parse(argv):
    p = argparse.ArgumentParser(prog="python -m skdownscale_tpu_torch.parallel.dryrun")
    p.add_argument("rank", type=int)
    p.add_argument("nprocs", type=int)
    p.add_argument("port", type=int)
    p.add_argument("store")
    p.add_argument("outdir")
    p.add_argument("--device", default="cuda")
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--sample-per-shard", type=int, default=8192)
    p.add_argument("--quantiles", type=int, default=2048)
    p.add_argument("--timeout", type=float, default=600.0, help="seconds a collective may wait")
    return p.parse_args(argv)


def dry_run(store: str, mesh, *, sample_per_shard: int = 8192, quantiles: int = 2048):
    """The dry run's work on ``mesh``: this process's slice of the store's
    ``gcm`` and ``obs`` fed through ``feed_zarr_cells``, the dense BCSD fit
    + predict on each local shard, the pooled quantile sketch of ``gcm``.
    Returns ``(output ShardedCells, ladder, n_valid, n_cells, feed seconds)``."""
    from ..global_models.quantile import ladder_positions, pooled_quantile_table
    from ..models.bcsd import BcsdTemperature, bcsd_fit, bcsd_predict
    from .zarr_io import feed_zarr_cells

    t0 = time.perf_counter()
    x, n_cells, index = feed_zarr_cells(store, mesh, var="gcm")
    y, n_cells_y, _ = feed_zarr_cells(store, mesh, var="obs")
    if n_cells_y != n_cells:
        raise ValueError(f"gcm has {n_cells} cells, obs {n_cells_y}")
    t_feed = time.perf_counter() - t0
    model = BcsdTemperature(return_anoms=False)
    fg = model._fit_groups(index)
    plan = model._predict_plan(fg, index)
    out = x.map(lambda xs, ys: bcsd_predict(bcsd_fit(xs, ys, fg), xs, plan, return_anoms=False), y)
    pp = ladder_positions(quantiles, x.dtype, mesh.devices[0])
    ladder, n_valid = pooled_quantile_table(x, pp, mesh, sample_per_shard=sample_per_shard)
    return out, ladder, int(n_valid), n_cells, t_feed


def main(argv=None) -> int:
    args = _parse(argv)
    if args.shards % args.nprocs:
        raise SystemExit(f"--shards {args.shards} does not split over {args.nprocs} processes")
    import torch
    import torch.distributed as dist

    from .mesh import cell_mesh

    if args.nprocs > 1:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                                world_size=args.nprocs, rank=args.rank,
                                timeout=datetime.timedelta(seconds=args.timeout))
    try:
        mesh = cell_mesh([torch.device(args.device)] * (args.shards // args.nprocs))
        t0 = time.perf_counter()
        out, ladder, n_valid, n_cells, t_feed = dry_run(
            args.store, mesh, sample_per_shard=args.sample_per_shard, quantiles=args.quantiles)
        rows = out.shape[0] // mesh.size
        shards = {str(k * rows): s.cpu().numpy() for k, s in zip(mesh.local_shards, out.shards)}
        ladder = ladder.cpu().numpy()
        wall = time.perf_counter() - t0
        os.makedirs(args.outdir, exist_ok=True)
        np.savez(os.path.join(args.outdir, f"shards_{args.rank}.npz"), **shards)
        np.savez(os.path.join(args.outdir, f"ladder_{args.rank}.npz"), ladder=ladder, n=n_valid)
        with open(os.path.join(args.outdir, f"meta_{args.rank}.json"), "w") as f:
            json.dump({"n_cells": int(n_cells), "global_shape": list(out.shape),
                       "process_count": mesh.world, "shards": mesh.size, "device": str(mesh.devices[0]),
                       "feed_s": t_feed, "wall_s": wall}, f)
        print(f"dryrun {args.rank}/{args.nprocs}: {len(shards)} shards of {rows} cells on "
              f"{mesh.devices[0]}, feed {t_feed:.3f} s, wall {wall:.3f} s", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(nprocs: int, store: str, outdir: str, *, device: str = "cuda", shards: int = 8,
            sample_per_shard: int = 8192, quantiles: int = 2048, timeout: float = 600.0):
    """Run a job of ``nprocs`` dry-run processes to its end (each killed
    after ``timeout`` seconds) and return :func:`assemble` of its output."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [_ROOT, os.environ.get("PYTHONPATH")])))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "skdownscale_tpu_torch.parallel.dryrun", str(rank), str(nprocs),
             str(port), store, outdir, "--device", device, "--shards", str(shards),
             "--sample-per-shard", str(sample_per_shard), "--quantiles", str(quantiles),
             "--timeout", str(timeout)],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(nprocs)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"a dry-run process exited {p.returncode}:\n{log[-4000:]}")
    return assemble(outdir, nprocs)


def assemble(outdir: str, nprocs: int):
    """``(output (n_cells, T), ladder, metas)`` of a finished job: the
    processes' shards tiled back into the global array, and the ladder,
    which every process must have computed alike."""
    metas = []
    for rank in range(nprocs):
        with open(os.path.join(outdir, f"meta_{rank}.json")) as f:
            metas.append(json.load(f))
    blocks = {}
    for rank in range(nprocs):
        with np.load(os.path.join(outdir, f"shards_{rank}.npz")) as z:
            blocks.update({int(start): z[start] for start in z.files})
    first = next(iter(blocks.values()))
    out = np.full(metas[0]["global_shape"], np.nan, first.dtype)
    seen = 0
    for start, block in blocks.items():
        out[start:start + block.shape[0]] = block
        seen += block.shape[0]
    if seen != out.shape[0] or any(m["process_count"] != nprocs for m in metas):
        raise ValueError(f"the shards of {outdir} do not tile the global array")
    ladders = []
    for rank in range(nprocs):
        with np.load(os.path.join(outdir, f"ladder_{rank}.npz")) as z:
            ladders.append((z["ladder"], int(z["n"])))
    if any(not np.array_equal(lad, ladders[0][0]) or n != ladders[0][1] for lad, n in ladders):
        raise ValueError("the processes computed different ladders")
    return out[: metas[0]["n_cells"]], ladders[0], metas


if __name__ == "__main__":
    sys.exit(main())
