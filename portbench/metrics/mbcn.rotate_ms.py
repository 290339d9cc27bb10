"""The device time a job of the traced window in the program's span
``sdt.mbcn.rotate`` (each round's rotation products, the rows laid out for K9 and K6, and the products back), ms: the stream's time between the CUDA
events the program records at the span's ends while a profiler records."""

from portbench.program_spans import per_job


def read(ctx):
    return per_job(ctx, "sdt.mbcn.rotate")
