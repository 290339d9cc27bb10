"""The mean over the window's jobs of the device time between CUDA events
recorded around the benchmark's span ``qm.transform`` (the call into the program),
ms."""


def read(ctx):
    ms = ctx.span_ms.get("qm.transform")
    return sum(ms) / len(ms) if ms else None
