"""Quality-guarded refit schedule: the animated frames' build path.

Port of ``tpu_raytracing/bvh/refit_schedule.py`` (``entry_surface_area``,
``GuardedRefit``). A topology-preserving refit (``bucket.refit_split``) is
far cheaper than a rebuild, but a refitted tree degrades as the geometry
deforms away from the topology it was built for: entry boxes inflate and
overlap, and the tracer's box tests climb. So the schedule is:

    refit every frame; rebuild in full when a cheap quality monitor trips
    (or a periodic frame cap, whichever comes first).

The monitor is the total surface area of the live inner entries: the SAH
cost of a tree is sum(SA(node) * P_visit), so SA_now / SA_at_rebuild is an
O(rows) proxy for the growth of the traversal cost. The value is one
device scalar, read one frame late: frame i's ratio gates frame i+1's
decision, so the read finds it long finished and does not stall the
frame that produced it. That read is the only host read the schedule
adds (a rebuild also reads the new tree's area, as the reference does).

Typical use (the app's ``--animate --refit``):

    sched = GuardedRefit(rebuild=lambda tris: build(tris))
    sched.seed(split0, packed0)              # frame 0's tree
    for t in frames:
        rows_t = deform(sched.rows0, t)      # fixed topology: deform the
        split, packed, rebuilt = sched.step(  # last rebuild's pair rows
            animate(tris0, t), rows_t)
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpu_raytracing_torch.bvh.bucket import SplitBVH, refit_split
from tpu_raytracing_torch.trace.traverse import PackedPairs, i2f
from tpu_raytracing_torch.utils import timing


def entry_surface_area(inner: torch.Tensor) -> torch.Tensor:
    """Total surface area of the live entries of a SplitBVH inner table, a
    float32 scalar on the table's device.

    Empty slots are inverted boxes (+max..-max, ``bvh/bucket.py``): they are
    masked out before the products, where their extents would overflow
    float32.
    """
    e = inner.reshape(-1, 8)
    d = i2f(e[:, 3:6]) - i2f(e[:, 0:3])
    live = (d >= 0.0).all(dim=1) & (e[:, 6] != 0)
    d = torch.where(live[:, None], d, 0.0)
    sa = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
    return sa.sum()


class GuardedRefit:
    """Refit every frame, with quality-guarded (and optionally periodic)
    full rebuilds; see the module docstring.

    ``rebuild(triangles) -> (SplitBVH, PackedPairs)`` is the full build; its
    tree must carry ``e_ranges`` (``bucket.emit_split`` or
    ``split_convert.build_sah_split``). ``refit(split0, packed_t) ->
    SplitBVH`` defaults to ``bucket.refit_split``.

    ``quality_bound``: rebuild when SA_now / SA_at_rebuild exceeds it (0
    turns the monitor off). ``max_interval``: rebuild at least every N
    frames (0 turns the cap off).
    """

    def __init__(self, rebuild: Callable[[torch.Tensor], Tuple[SplitBVH, PackedPairs]],
                 refit: Optional[Callable] = None, quality_bound: float = 1.3,
                 max_interval: int = 0):
        self._rebuild = rebuild
        self._refit = refit if refit is not None else refit_split
        self.quality_bound = float(quality_bound)
        self.max_interval = int(max_interval)
        self.split0: Optional[SplitBVH] = None
        self.rows0 = None  # pair rows at the last rebuild (sorted order)
        self.sa0 = None  # host float at the last rebuild
        self.pending_sa = None  # device scalar from the previous frame
        self.frames_since_rebuild = 0
        self.rebuild_count = 0

    def seed(self, split: SplitBVH, packed: PackedPairs) -> None:
        """Adopt an existing build (frame 0's, built outside the schedule)
        as the rebuild point, so the first animated frame refits."""
        self.split0 = split
        self.rows0 = packed.rows
        self.sa0 = float(entry_surface_area(split.inner))
        self.pending_sa = None
        self.frames_since_rebuild = 0

    def _guard_trips(self) -> Optional[str]:
        """Why this frame rebuilds (``"unseeded"``, ``"interval"`` or
        ``"monitor"``), or None."""
        if self.split0 is None:
            return "unseeded"
        if self.max_interval and self.frames_since_rebuild >= self.max_interval:
            return "interval"
        if self.quality_bound and self.pending_sa is not None:
            # one frame late: the previous frame's scalar is long finished
            ratio = float(self.pending_sa) / max(self.sa0, 1e-30)
            if ratio > self.quality_bound:
                return "monitor"
        return None

    def step(self, triangles_t: torch.Tensor, rows_t: Optional[torch.Tensor] = None):
        """Advance one animated frame.

        ``triangles_t``: this frame's geometry in input (triangle) order,
        used only when a rebuild runs. ``rows_t``: this frame's pair rows in
        the current tree's sorted order (``rows0`` deformed); None forces a
        rebuild (first frame, or changed topology). Returns (split, packed,
        rebuilt). While ``timing.tracing()`` it counts the frame
        (``refit.frames``) and a rebuild under its reason
        (``refit.rebuild.<reason>``: ``forced`` without ``rows_t``, else
        ``_guard_trips``').
        """
        timing.count("refit.frames", 1)
        reason = "forced" if rows_t is None else self._guard_trips()
        if reason is not None:
            timing.count(f"refit.rebuild.{reason}", 1)
            split, packed = self._rebuild(triangles_t)
            self.seed(split, packed)
            self.rebuild_count += 1
            return split, packed, True
        packed_t = PackedPairs(rows=rows_t)
        split_t = self._refit(self.split0, packed_t)
        self.pending_sa = entry_surface_area(split_t.inner)
        self.frames_since_rebuild += 1
        return split_t, packed_t, False
