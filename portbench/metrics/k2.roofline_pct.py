"""K2's roofline share in the traced window, % (``roofline/k2.py``)."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, "k2")
