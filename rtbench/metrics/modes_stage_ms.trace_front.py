"""Self stream time per profiled image of the render modes' tracer spans
(``render_frame.trace``, ``render_frame.shadow_trace``), K6 left out:
tiling and the hit record."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["render_frame.trace", "render_frame.shadow_trace"])
