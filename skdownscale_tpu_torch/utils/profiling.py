"""Profiling and tracing hooks on ``torch.profiler``.

Port of ``skdownscale_tpu/utils/profiling.py``: :func:`annotate` names a
range in a profiler trace, :func:`trace_to` records the host and CUDA
activity of a block as a Chrome trace, and :class:`StageTimer` keeps
wall-clock totals per stage, synchronising the CUDA device of a tensor it
is given before it stops the clock (PyTorch returns before the device is
done).

The port's own spans are :func:`annotate` ranges named ``sdt.<layer>.<step>``
at the layer boundaries of its cores (``sdt.qm.fit``, ``sdt.mbcn.rotate``,
...): ``record_function`` ranges on the profiler's host timeline, which the
device activity is traced against, so a kernel is put down to the span that
launched it.  While a profiler records, each span also keeps its count, its
host time and, once CUDA is in use, a CUDA event on the current stream at
each end (a host wait keeps no events: it would record them where the card
waits for the host): :func:`recorded_spans` sums them for the latest
stretch in which a profiler recorded, for a caller that wants the totals
without reading the trace.  :func:`host_wait` marks each place where the host waits for the
device (a copy from pageable host memory, a read of a device value) and
counts the passes in :data:`HOST_WAITS` by site, on every device and
whether or not a profiler records.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter, defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["HOST_WAITS", "annotate", "host_wait", "recorded_spans", "StageTimer", "trace_to"]

# passes through each host-wait site (``host_wait(site)``), by site
HOST_WAITS: Counter = Counter()

_OFF = contextlib.nullcontext()

# the spans of the latest stretch in which a profiler recorded, by name:
# [count, host seconds, [(start, stop) CUDA events]]
_RECORD: dict[str, list] = {}
_stretch_open = False  # whether the last span saw a profiler recording


def annotate(name: str):
    """A named range in a ``torch.profiler`` trace (``record_function``),
    kept in the record of :func:`recorded_spans`, while a profiler records;
    otherwise a shared no-op context, whose only cost is reading the
    profiler's flag.  The first span of a stretch of profiling starts the
    record anew."""
    return _span(name, True)


def host_wait(site: str):
    """A place where the host waits for the device: adds 1 to
    ``HOST_WAITS[site]`` and, while a profiler records, is the range
    ``sdt.wait.<site>``, kept in the record with no CUDA events.  Wrap one
    wait (one copy, one read) a call."""
    HOST_WAITS[site] += 1
    return _span("sdt.wait." + site, False)


def _span(name: str, timed: bool):
    """A :class:`_Span` while a profiler records, else the shared no-op."""
    global _stretch_open
    if _autograd_profiler._is_profiler_enabled:
        if not _stretch_open:
            _RECORD.clear()
            _stretch_open = True
        return _Span(name, timed)
    _stretch_open = False
    return _OFF


def _event():
    """A timing CUDA event recorded on the current stream, or None where
    CUDA is not in use."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """A ``record_function`` range that adds its count, host time and
    (``timed``) CUDA events to the record when it closes."""

    __slots__ = ("name", "timed", "_range", "_start", "_t0")

    def __init__(self, name: str, timed: bool):
        self.name, self.timed = name, timed

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = _event() if self.timed else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self._t0
        entry = _RECORD.setdefault(self.name, [0, 0.0, []])
        entry[0] += 1
        entry[1] += host_s
        if self._start is not None:
            entry[2].append((self._start, _event()))
        return self._range.__exit__(*exc)


def recorded_spans() -> dict:
    """``{name: {"count", "host_ms", "device_ms"}}`` of the spans of the
    latest stretch in which a profiler recorded (empty before any; a
    stretch ends at the first span that finds no profiler recording):
    ``device_ms`` sums the time between each range's two CUDA events on the
    stream it was opened on, None for a host wait and where CUDA was not in
    use.  Read it once the device has done the stretch's work."""
    out = {}
    for name, (count, host_s, events) in _RECORD.items():
        device_ms = sum(a.elapsed_time(b) for a, b in events) if events else None
        out[name] = {"count": count, "host_ms": host_s * 1e3, "device_ms": device_ms}
    return out


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
