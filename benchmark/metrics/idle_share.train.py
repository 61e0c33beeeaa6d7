"""Share of the profiled training steps' wall time with the device idle."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
