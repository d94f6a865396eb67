"""The instance sweep kernel's share of its roofline: the least time of a
frame's sweep bytes (``rtbench/instanced_roofline.py``: the instanced
calls' live rays and overlaps, the program's counters ``inst.rays``,
``inst.items`` and ``inst.calls``, and the instances once a call) over the
sweep kernel's device time per profiled frame. None where the kernel did
not run."""

from rtbench import instanced_roofline, spans, tracefold


def read(ctx):
    f = ctx["folded"]
    c = spans.counters("inst.")
    if not f or not c.get("inst.calls"):
        return None
    ms = tracefold.device_us_matching(f, "inst_sweep_kernel") / f["frames"] / 1e3
    return instanced_roofline.sweep_roofline_pct(c["inst.rays"], c["inst.items"],
                                                 c["inst.calls"], ctx["num_instances"],
                                                 f["frames"], ms)
