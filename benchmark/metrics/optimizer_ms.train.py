"""Device ms per training step in Adam and the densify statistics (optimizer and densify.stats)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", ("optimizer", "densify.stats"))
