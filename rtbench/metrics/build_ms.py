"""Mean per frame of the program's synchronised build stages
(``animated_trees``' records: Animate and SplitBuild, or Animate,
DeformRows and RefitSchedule), over the counted steps: the profiled
stretch's cycle positions one period later, outside the profiler."""


def read(ctx):
    ms = ctx["build_ms"]
    return sum(ms) / len(ms) if ms else None
