"""Device ms per served view in no stage's span: waits on host work, the uint8 cast and copy."""

from benchmark import spans


def read(ctx):
    return spans.outside_stages_ms(ctx, "serve")
