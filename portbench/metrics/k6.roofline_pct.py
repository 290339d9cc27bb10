"""K6's roofline share in the traced window, % (``roofline/k6.py``)."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, "k6")
