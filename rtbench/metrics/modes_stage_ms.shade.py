"""Self stream time per profiled image of the render modes'
``render_frame.shade`` spans, the shadow trace left out."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["render_frame.shade"])
