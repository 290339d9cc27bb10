"""The share of the traced window in which no kernel, copy or fill ran on
the device, from the profiler's device timeline, %."""


def read(ctx):
    if not ctx.window_s or ctx.busy_s is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
