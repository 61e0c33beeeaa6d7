"""Device ms per training step in the backward's torch ops (outside K2, K3, the gather)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "train", ("train.backward",))
