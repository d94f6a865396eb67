"""Share of the refit schedule's frames that rebuilt in full, whatever
tripped the rebuild: the program's counters ``refit.rebuild.*`` over
``refit.frames``, in the profiled frames."""

from rtbench import spans


def read(ctx):
    c = spans.counters("refit.")
    frames = c.pop("refit.frames", 0)
    return 100.0 * sum(c.values()) / frames if frames else None
