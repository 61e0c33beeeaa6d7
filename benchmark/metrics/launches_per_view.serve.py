"""Device kernels launched per served view (profiler count)."""

from benchmark import readers


def read(ctx):
    return readers.launches_per_unit(ctx, "serve")
