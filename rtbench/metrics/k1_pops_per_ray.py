"""K1's inner and leaf pops per live ray over the profiled frames: the
program's counters ``k1.pops`` over ``k1.rays``."""

from rtbench import spans


def read(ctx):
    c = spans.counters("k1.")
    return c["k1.pops"] / c["k1.rays"] if c.get("k1.rays") else None
