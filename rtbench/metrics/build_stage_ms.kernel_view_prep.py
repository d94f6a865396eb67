"""Self stream time per profiled frame of the split build's
``build.kernel_view_prep`` spans."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.kernel_view_prep"])
