"""Device time inside the ``render_frame`` span per profiled image, less
K6's: the render modes' ray generation, tiling, gathers and shading."""

from rtbench import tracefold


def read(ctx):
    f = ctx["folded"]
    if not f:
        return None
    span = f["span_device_us"].get(tracefold.SPAN_PREFIX + "render_frame", 0.0)
    if span <= 0:
        return None
    k6 = tracefold.device_us_matching(f, "fat_traverse", span="render_frame")
    return (span - k6) / f["frames"] / 1e3
