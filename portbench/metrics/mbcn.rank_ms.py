"""The device time a job of the traced window in the program's span
``sdt.mbcn.rank`` (each round's K9 sorts and rank map, and the reorder's three K9 forms), ms: the stream's time between the CUDA
events the program records at the span's ends while a profiler records."""

from portbench.program_spans import per_job


def read(ctx):
    return per_job(ctx, "sdt.mbcn.rank")
