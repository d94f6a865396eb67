"""Self stream time per profiled frame of the path tracer's four tracer
spans (``path_trace.primary``, ``.primary_shadow``, ``.bounce``,
``.bounce_shadow``), K1 left out: tiling, ``kernel_operands``,
``reconstruct``."""

from rtbench import spans

PASSES = ("primary", "primary_shadow", "bounce", "bounce_shadow")


def read(ctx):
    return spans.stage_ms(ctx, [f"path_trace.{p}" for p in PASSES])
