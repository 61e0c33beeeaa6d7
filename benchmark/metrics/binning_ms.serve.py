"""Device ms per served view in binning (self time of raster.binning)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "serve", ("raster.binning",))
