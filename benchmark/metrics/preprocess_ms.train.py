"""Device ms per training step in preprocess and the render's set-up."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", ("raster.preprocess", "render.setup"))
