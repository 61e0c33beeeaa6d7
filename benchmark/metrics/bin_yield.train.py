"""Share of the slots binning's expansion tested that it kept, per training run."""

from benchmark import spans


def read(ctx):
    return spans.bin_yield(ctx, "train")
