"""Mean per frame of the instanced scene kind's ``step``: the instance
level rebuilt from the moved transforms (``instance_level``, synchronised,
the transforms' copy to the device included), over the counted steps: the
profiled stretch's cycle positions one period later, outside the
profiler."""


def read(ctx):
    ms = ctx["build_ms"]
    return sum(ms) / len(ms) if ms else None
