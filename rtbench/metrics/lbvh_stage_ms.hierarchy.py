"""Self stream time per profiled frame of the Karras build's
``build.lbvh.hierarchy`` spans: the Karras hierarchy (GenerateHierarchy)."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.lbvh.hierarchy"])
