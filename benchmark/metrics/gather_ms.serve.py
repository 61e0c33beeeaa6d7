"""Device ms per served view in the dup gather."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "serve", ("raster.gather",))
