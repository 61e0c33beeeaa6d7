"""Device ms per refinement step building the bound Gaussians (bound.gaussians)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", ("bound.gaussians",), self_only=False)
