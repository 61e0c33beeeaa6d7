"""Device ms per served view in preprocess and the render's set-up."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "serve", ("raster.preprocess", "render.setup"))
