"""K9's roofline share in the traced window, % (``roofline/k9.py``)."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, "k9")
