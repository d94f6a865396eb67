"""Share of the profiled frames' wall time in which no operation ran on
the device: 1 minus the union of the device's operation intervals."""


def read(ctx):
    f = ctx["folded"]
    if not f or f["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - f["busy_us"] / f["window_us"])
