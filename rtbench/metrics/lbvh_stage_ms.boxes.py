"""Self stream time per profiled frame of the Karras build's
``build.lbvh.boxes`` spans: the sorted pairs and their boxes up the tree
(GenerateTriangles, GenerateAABBs)."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.lbvh.boxes"])
