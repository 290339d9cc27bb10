"""The host's waits for the device a job of the traced window: the passes
through the program's host-wait sites, each a span ``sdt.wait.<site>``
while the profiler records (``HOST_WAITS`` counts the same passes)."""

from portbench.program_spans import waits_per_job


def read(ctx):
    return waits_per_job(ctx, "count")
