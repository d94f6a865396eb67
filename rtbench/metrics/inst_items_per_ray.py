"""Instance overlaps per live ray of the instanced calls over the profiled
frames: the program's counters ``inst.items`` (every overlap, before the
item slots' cap) over ``inst.rays``."""

from rtbench import spans


def read(ctx):
    c = spans.counters("inst.")
    return c["inst.items"] / c["inst.rays"] if c.get("inst.rays") else None
