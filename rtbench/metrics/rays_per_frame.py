"""Rays the path tracer traced per frame (its returned count), in
millions, over the counted steps: the profiled stretch's cycle positions
one period later, outside the profiler."""


def read(ctx):
    rays = ctx["rays"]
    return sum(rays) / len(rays) / 1e6 if rays else None
