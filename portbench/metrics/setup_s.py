"""Seconds from the process's start to the first timed job: imports, the
card's start, the cell's libraries (built on a checkout's first run),
the inputs made on the card and the warm-up jobs."""


def read(ctx):
    return ctx.setup_s
