"""Self stream time per profiled frame of the instanced tracers'
``inst.items`` spans: the item keys, their sort
and the items' mapping into object space."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["inst.items"])
