"""Device ms per served view outside K1, K2 and K3."""

from benchmark import readers


def read(ctx):
    return readers.torch_ops_ms(ctx, "serve")
