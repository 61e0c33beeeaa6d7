"""Host ms per training step in the loop's device-to-host overflow read (caps.read)."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "train", ("caps.read",))
