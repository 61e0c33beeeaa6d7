"""Device ms per training step in binning (self time of raster.binning)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", ("raster.binning",))
