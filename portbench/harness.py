"""One run of one cell: set-up, the measured window, the traced window's
reading, the check against the plain reference, and the result line.

The window runs whole jobs back to back from this one host thread, with no
synchronise between them, the jobs taking the cell's input sets in turn,
until ``--seconds`` have passed; one synchronise ends it.  The outputs of
the first and the last job on each input set stay on the card (as a
script keeps its results for the next step) and are judged once the
window has closed.  Set-up runs the same loop over three jobs a set first,
so that no library loads and no kernel builds inside the window, and no
memory is first taken from the card there: a set's third job is the first
to write while four outputs are held, as every later job does.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

from . import catalog, generator, roofline
from . import trace as trace_reader

# top-level modules that may not be loaded in the process that prints the
# result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "skdownscale_tpu")
WARMUP_JOBS_PER_SET = 3
IDLE_CARD_JOBS = 3  # jobs issued on an idle card after a traced window (entry.host_ms)


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names of :data:`FORBIDDEN` among ``modules`` (default:
    ``sys.modules``), compared whole: ``skdownscale_tpu_torch`` is not
    ``skdownscale_tpu``."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def process_age_s(fallback_start: float) -> float:
    """Seconds since this process started (``/proc/self/stat`` against
    ``/proc/uptime``, 10 ms steps); without them, since ``fallback_start``
    (``time.time()`` taken first thing by the command)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - fallback_start


def card_line() -> str:
    """The card's name and power limit from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no card line (power limit not read)"


def build_libraries(names) -> dict:
    """Build (or find built) the cell's own CUDA libraries side by side:
    ``{name: seconds of nvcc}`` (0 where the checkout has it built)."""
    from skdownscale_tpu_torch.kernels import build

    out, errors = {}, []

    def one(name):
        try:
            out[name] = build.build(name).seconds
        except Exception as exc:  # re-raised below, on the main thread
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


class Spans:
    """The benchmark's spans around its calls into the program.  Off: no
    cost.  On (a traced run): a ``record_function`` range named
    ``portbench.<name>`` and CUDA events before and after, read once the
    window has closed."""

    def __init__(self, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self.events: dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        with torch.profiler.record_function(trace_reader.PREFIX + name):
            if self.cuda:
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            yield
            if self.cuda:
                stop.record()
                self.events.setdefault(name, []).append((start, stop))

    def device_ms(self) -> dict:
        return {name: [a.elapsed_time(b) for a, b in ev] for name, ev in self.events.items()}


def _off(name):
    return contextlib.nullcontext()


def run_jobs(system, inputs, spans, until=None, count=None):
    """Jobs back to back, on the input sets in turn, until the host clock
    passes ``until`` (whole jobs) or ``count`` jobs have run.  Returns
    (jobs, {set: [its first job's outputs, its last job's if another]})."""
    first, last = {}, {}
    jobs = 0
    while True:
        k = jobs % len(inputs)
        out = system.run(inputs[k], spans)
        first.setdefault(k, out)
        last[k] = out
        jobs += 1
        if (count is not None and jobs >= count) or (until is not None and time.perf_counter() >= until):
            return jobs, {k: [first[k]] + ([last[k]] if last[k] is not first[k] else []) for k in first}


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        cell: dict | None = None, started: float | None = None, log=print) -> dict:
    """One run of the cell ``cell_name`` (or of ``cell``, a resolved cell
    as :func:`catalog.cell` gives, for the tests' small sizes): the result
    line as a dict, whose ``check`` holds each compared number with its
    limit.  ``device="cpu"`` skips the card's libraries (the tests)."""
    import torch

    import skdownscale_tpu_torch  # noqa: F401  (the program; switches TF32 off)

    started = time.time() if started is None else started
    cell = cell or catalog.cell(cell_name)
    config, traffic = cell["config"], cell["traffic"]
    cuda = device.startswith("cuda")
    if cuda:
        built = build_libraries(config["kernels"])
        log(f"libraries {built} (seconds of nvcc; 0: built before)")
    system = catalog.system(config["system"]).System(config, traffic, seed, device)
    inputs = generator.inputs(traffic, seed, device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    run_jobs(system, inputs, _off, count=WARMUP_JOBS_PER_SET * len(inputs))
    sync()
    setup_s = process_age_s(started)

    spans = Spans(trace, cuda)
    prof = None
    launch_shapes = {}
    with contextlib.ExitStack() as traced:
        if trace:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
            traced.enter_context(roofline.recording(catalog.roofline_kernels(), launch_shapes))
            traced.enter_context(torch.profiler.record_function(trace_reader.WINDOW))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        jobs, kept = run_jobs(system, inputs, spans, until=t0 + seconds)
        sync()
        elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    reading, host_issue_ms = None, []
    if trace:
        prof.__exit__(None, None, None)
        reading = trace_reader.read(prof)
        del prof
        if reading:
            by_time = sorted(reading["kernel_s"].items(), key=lambda kv: -kv[1])
            log("device seconds in the window by function: " + json.dumps(dict(by_time)))
        for i in range(IDLE_CARD_JOBS):
            sync()
            h0 = time.perf_counter()
            system.run(inputs[i % len(inputs)], _off)
            host_issue_ms.append((time.perf_counter() - h0) * 1e3)
        sync()

    ctx = SimpleNamespace(
        cell=cell, jobs=jobs,
        cells_per_job=int(traffic["cells"]), elapsed_s=elapsed, setup_s=setup_s, peak_bytes=peak,
        span_ms=spans.device_ms(), host_issue_ms=host_issue_ms, launch_shapes=launch_shapes,
        kernel_s=reading["kernel_s"] if reading else None,
        busy_s=reading["busy_s"] if reading else None,
        window_s=reading["window_s"] if reading else None,
    )
    metrics = {}
    for entry in catalog.metrics_for(cell["name"], trace):
        value = catalog.metric_reader(entry["name"])(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}

    # the check, once the window has closed and the peak has been read
    limits = cell["limits"]
    numbers = {name: 0.0 for name in limits}
    failed = 0
    for k, outs in kept.items():
        for reading_k in system.check(inputs[k], outs):
            failed += any(not reading_k[n] <= limits[n] for n in limits)
            for n in limits:
                numbers[n] = max(numbers[n], reading_k[n])
    correct = failed == 0

    result = {"correct": correct, "attempted": jobs, "failed": failed, "metrics": metrics}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name() if cuda else "cpu",
                        "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if reading:
        result["device"].update(busy_s=reading["busy_s"], window_s=reading["window_s"])
        result["breakdown"] = {"device_ops": reading["device_ops"], "idle_gaps": reading["idle_gaps"]}
    result["check"] = {n: {"value": numbers[n], "limit": limits[n]} for n in limits}
    return result
