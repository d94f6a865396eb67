"""Self stream time per profiled frame of the instanced tracers'
``inst.resolve`` spans: each ray's winner or
occlusion, its record, instance ids and statistics."""

from rtbench import spans


def read(ctx):
    return spans.stage_ms(ctx, ["inst.resolve"])
