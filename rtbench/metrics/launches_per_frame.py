"""Device kernels per profiled frame (copies and sets not counted)."""


def read(ctx):
    f = ctx["folded"]
    if not f or not f["frames"]:
        return None
    return f["launches"] / f["frames"]
