"""The device time a job of the traced window in the program's span
``sdt.mbcn.margins`` (MBCn's step 1, the QDM margins), ms: the stream's time between the CUDA
events the program records at the span's ends while a profiler records."""

from portbench.program_spans import per_job


def read(ctx):
    return per_job(ctx, "sdt.mbcn.margins")
