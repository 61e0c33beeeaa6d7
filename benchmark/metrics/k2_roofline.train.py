"""K2's least time for a step's needed work over its device time."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "train", "k2")
