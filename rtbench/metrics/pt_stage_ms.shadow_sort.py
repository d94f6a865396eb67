"""Self stream time per profiled frame of the path tracer's
``path_trace.shadow_sort`` spans."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["path_trace.shadow_sort"])
