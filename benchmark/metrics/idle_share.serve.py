"""Share of the profiled views' wall time with the device idle."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")
