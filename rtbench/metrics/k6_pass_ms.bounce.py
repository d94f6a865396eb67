"""K6's stream time per profiled frame on the bounce passes, summed over the
bounces: the program's ``k6`` spans (one launch each) under
``path_trace.bounce``."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["k6"], parents=["path_trace.bounce"])
