"""Profiling and tracing hooks on ``torch.profiler``.

Port of ``skdownscale_tpu/utils/profiling.py``: :func:`annotate` names a
range in a profiler trace, :func:`trace_to` records the host and CUDA
activity of a block as a Chrome trace, and :class:`StageTimer` keeps
wall-clock totals per stage, synchronising the CUDA device of a tensor it
is given before it stops the clock (PyTorch returns before the device is
done).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["annotate", "StageTimer", "trace_to"]


def annotate(name: str):
    """A named range in a ``torch.profiler`` trace (``record_function``)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Record the enclosed block's host and CUDA activity and write it to
    ``logdir`` as a Chrome trace (``trace.json``; open it in Perfetto or
    ``chrome://tracing``).  Yields the profiler, whose ``key_averages()``
    sums the time by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a (nested) tuple, list or dict."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


class StageTimer:
    """Wall-clock stage accounting with device barriers.

    ``stage(name, sync=x)`` synchronises the CUDA device of every tensor in
    ``x`` (a tensor or a tuple, list or dict of them) before the clock
    stops; a CPU tensor needs no barrier.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        with annotate(name):
            yield
            if sync is not None:
                for dev in _cuda_devices(sync):
                    torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage                          total_s  calls   mean_ms"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<30} {tot:7.3f} {n:6d} {1000 * tot / n:9.2f}")
        return "\n".join(lines)
