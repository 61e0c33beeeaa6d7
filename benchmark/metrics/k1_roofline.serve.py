"""K1's least time for a view's needed work over its device time."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "serve", "k1")
