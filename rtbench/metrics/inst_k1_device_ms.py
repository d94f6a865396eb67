"""Device time of K1 (the split traversal kernel) per profiled frame in
the instanced cell: one object-space launch for every instanced call."""

from rtbench import tracefold


def read(ctx):
    f = ctx["folded"]
    us = tracefold.device_us_matching(f, "split_trace_kernel") if f else 0.0
    return us / f["frames"] / 1e3 if us > 0 else None
