"""Reading the program's own spans over the traced window.

While a profiler records, each of the program's ``sdt.<layer>.<step>``
spans keeps its count, its host time and, on the card, a CUDA event on the
stream at each end (``skdownscale_tpu_torch.utils.profiling.recorded_spans``);
the program starts that record anew with each stretch of profiling, and a
run's one stretch is its traced window.  A span's device time is the
stream's time between its two events: the work it launched, and the idle
time it left inside itself.  The host waits are the spans
``sdt.wait.<site>``, one a pass through a wait site.  A program without
the record gives nothing, and its metrics are left out of the line.
"""

from __future__ import annotations

SPAN = "sdt."
WAIT = SPAN + "wait."


def recorded() -> dict | None:
    """The program's record of the window's spans, or None where the program
    keeps none or no span of it ran while the profiler recorded."""
    try:
        from skdownscale_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    return recorded_spans() or None


def per_job(ctx, name: str):
    """The device ms of the span ``name`` a job of the window, or None
    where the record holds no such span or no device time."""
    spans = recorded()
    if not spans or name not in spans or not ctx.jobs:
        return None
    value = spans[name]["device_ms"]
    return None if value is None else value / ctx.jobs


def waits_per_job(ctx, field: str):
    """The sum of ``field`` (``count`` or ``host_ms``) over the host-wait
    spans, a job of the window: 0 where the program's spans ran and none of
    them waited; None where the program keeps no record."""
    spans = recorded()
    if not spans or not ctx.jobs:
        return None
    return sum(s[field] for name, s in spans.items() if name.startswith(WAIT)) / ctx.jobs
