"""Self stream time per profiled frame of the Karras build's
``build.lbvh.morton`` spans: the scene box, the Morton codes and the pairing
(the reference's GenerateMortonCodesPairs)."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["build.lbvh.morton"])
