"""Device time inside the ``path_trace`` span per profiled frame, less
K1's: the path tracer and the split tracer's front end (ray generation,
shading, compaction sorts, gathers)."""

from rtbench import tracefold


def read(ctx):
    f = ctx["folded"]
    if not f:
        return None
    span = f["span_device_us"].get(tracefold.SPAN_PREFIX + "path_trace", 0.0)
    if span <= 0:
        return None
    k1 = tracefold.device_us_matching(f, "split_trace_kernel", span="path_trace")
    return (span - k1) / f["frames"] / 1e3
