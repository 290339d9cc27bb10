"""Cells of every job completed in the window over the time from the
window's start to the synchronise that ends its last job (host clock)."""


def read(ctx):
    return ctx.jobs * ctx.cells_per_job / ctx.elapsed_s if ctx.jobs and ctx.elapsed_s > 0 else None
