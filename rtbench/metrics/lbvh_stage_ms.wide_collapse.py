"""Self stream time per profiled frame of the wide tracer's
``build.wide_collapse`` spans: the stack-depth check and the collapse of the
frame's Karras tree to fat 8-wide rows."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.wide_collapse"])
