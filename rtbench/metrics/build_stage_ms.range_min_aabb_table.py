"""Self stream time per profiled frame of the split build's
``build.range_min_aabb_table`` spans."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.range_min_aabb_table"])
