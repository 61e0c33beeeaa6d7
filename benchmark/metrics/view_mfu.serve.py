"""A served view's needed fp32 operations over its time, against the fp32 peak."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "serve")
