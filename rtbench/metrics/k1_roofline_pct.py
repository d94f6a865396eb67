"""K1's share of its roofline: the least time of one frame's traversal
bytes (``rtbench/roofline.py``) over K1's device time per frame."""

from rtbench import roofline, tracefold


def read(ctx):
    f = ctx["folded"]
    if not f or not ctx["counted_steps"] or not ctx["live"]:
        return None
    ms = tracefold.device_us_matching(f, "split_trace_kernel") / f["frames"] / 1e3
    frames = ctx["counted_steps"] * ctx["images_per_step"]
    calls = [n for counts in ctx["live"].values() for n in counts]
    nbytes = roofline.frame_bytes(calls, 0) / frames + ctx["num_triangles"] * \
        roofline.TRIANGLE_BYTES
    return roofline.roofline_pct(nbytes, ms)
