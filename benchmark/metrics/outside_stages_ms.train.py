"""Device ms per training step in no stage's span: waits on host work between stages and steps."""

from benchmark import spans


def read(ctx):
    return spans.outside_stages_ms(ctx, "train")
