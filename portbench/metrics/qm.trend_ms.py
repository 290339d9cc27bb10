"""The device time a job of the traced window in the program's span
``sdt.qm.trend`` (the trend fits, detrends and the retrend of a quantile-mapping job), ms: the stream's time between the CUDA
events the program records at the span's ends while a profiler records."""

from portbench.program_spans import per_job


def read(ctx):
    return per_job(ctx, "sdt.qm.trend")
