"""Device kernels launched per training step (profiler count)."""

from benchmark import readers


def read(ctx):
    return readers.launches_per_unit(ctx, "train")
