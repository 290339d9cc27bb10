"""What it costs the host to issue one job: host clock from the job's first
call into the program to the return of its last, no synchronise inside,
each job started on an idle card after the window (so that a full launch
queue does not make the host wait); the median of those jobs, ms."""

import statistics


def read(ctx):
    return statistics.median(ctx.host_issue_ms) if ctx.host_issue_ms else None
