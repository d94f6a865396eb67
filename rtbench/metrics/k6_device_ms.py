"""Device time of K6 (the fat traversal kernel, both instantiations) per
profiled frame."""

from rtbench import tracefold


def read(ctx):
    f = ctx["folded"]
    us = tracefold.device_us_matching(f, "fat_traverse") if f else 0.0
    return us / f["frames"] / 1e3 if us > 0 else None
