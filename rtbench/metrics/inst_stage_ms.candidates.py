"""Self stream time per profiled frame of the instanced tracers'
``inst.candidates`` spans: the candidate sweep (the
sweep kernel on the card)."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["inst.candidates"])
