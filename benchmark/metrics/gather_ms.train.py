"""Device ms per training step in the dup gather and its backward, K3 left out."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", ("raster.gather", "raster.gather_bwd"))
