"""Self stream time per profiled frame of the Karras build's
``build.lbvh.sort`` spans: the codes' stable sort (RadixSort)."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.lbvh.sort"])
