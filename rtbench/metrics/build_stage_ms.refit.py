"""Self stream time per profiled frame of the split build's
``build.refit`` spans."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.refit"])
