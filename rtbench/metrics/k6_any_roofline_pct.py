"""K6's any-hit instantiation's share of its roofline: the least time of
one frame's shadow-ray traversal bytes (``rtbench/roofline.py``: the live
rays of the shadow tracers' calls, and the triangles once) over that
kernel's device time per frame. None where the kernel did not run."""

from rtbench import roofline, tracefold


def read(ctx):
    f = ctx["folded"]
    calls = [n for name, counts in ctx["live"].items() if "shadow" in name for n in counts]
    if not f or not ctx["counted_steps"] or not calls:
        return None
    ms = tracefold.device_us_matching(f, "fat_traverse_any") / f["frames"] / 1e3
    frames = ctx["counted_steps"] * ctx["images_per_step"]
    nbytes = roofline.frame_bytes(calls, 0) / frames + ctx["num_triangles"] * \
        roofline.TRIANGLE_BYTES
    return roofline.roofline_pct(nbytes, ms)
