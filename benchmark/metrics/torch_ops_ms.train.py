"""Device ms per training step outside K1, K2 and K3."""

from benchmark import readers


def read(ctx):
    return readers.torch_ops_ms(ctx, "train")
