"""Self stream time per profiled frame of the split build's
``build.bucket_tables`` spans."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.bucket_tables"])
