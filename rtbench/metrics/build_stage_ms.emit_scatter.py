"""Self stream time per profiled frame of the split build's
``build.emit_scatter`` spans."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.emit_scatter"])
