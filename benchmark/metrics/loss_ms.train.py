"""Device ms per training step in the loss, normal consistency included."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", ("loss",), self_only=False)
