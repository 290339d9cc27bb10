"""The mean over the window's jobs of the device time between CUDA events
recorded around the benchmark's span ``mbcn.correct`` (the call into the program),
ms."""


def read(ctx):
    ms = ctx.span_ms.get("mbcn.correct")
    return sum(ms) / len(ms) if ms else None
