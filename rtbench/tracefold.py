"""Reduction of a profiled window to device busy time, kernel times, span
device times and idle gaps.

Events are plain tuples ``(name, kind, start_us, end_us)``: ``kind`` is
``"device"`` for an operation on the card (kernel, copy or set), ``"span"``
for one of the harness's own spans (names starting ``rtbench.``) and
``"host"`` for any other host-side event (a PyTorch operator, a runtime
call). Every span the harness opens ends with the device idle (a frame
ends with its read-back; the program's build stages and tracers end with a
host read), so a device operation belongs to the span whose host interval
holds its midpoint.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SPAN_PREFIX = "rtbench."
FRAME_SPAN = SPAN_PREFIX + "frame"
# device operations that are copies or sets, not kernels
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")

Event = Tuple[str, str, float, float]


def union_us(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    return sum(b - a for a, b in union_us(intervals))


def is_kernel(name: str) -> bool:
    return not name.startswith(_NOT_KERNELS)


def _innermost(events: Sequence[Event], points: Sequence[float]) -> List[Optional[str]]:
    """For each point (sorted ascending), the name of the covering event
    that started last, or None."""
    order = sorted(events, key=lambda e: e[2])
    out: List[Optional[str]] = []
    heap: list = []
    i = 0
    for p in points:
        while i < len(order) and order[i][2] <= p:
            heapq.heappush(heap, (-order[i][2], i))
            i += 1
        while heap and order[heap[0][1]][3] < p:
            heapq.heappop(heap)
        out.append(order[heap[0][1]][0] if heap else None)
    return out


def fold(events: Sequence[Event], top: int = 10) -> Dict:
    """Everything the per-layer readers take from a profiled window of
    whole frames (the ``rtbench.frame`` spans): the window's wall time,
    the device's busy time, kernels and their times by name, the device
    time inside each span name, and the idle gaps by what the host was
    doing. Times in microseconds."""
    frames = sorted((e for e in events if e[1] == "span" and e[0] == FRAME_SPAN),
                    key=lambda e: e[2])
    if not frames:
        return {}
    w0, w1 = frames[0][2], frames[-1][3]
    device = [e for e in events if e[1] == "device" and not e[0].startswith(SPAN_PREFIX)
              and e[3] > w0 and e[2] < w1]
    clipped = [(max(e[2], w0), min(e[3], w1)) for e in device]
    busy = union_us(clipped)
    by_name: Dict[str, float] = {}
    for name, _, a, b in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)

    spans = sorted((e for e in events if e[1] == "span" and e[0] != FRAME_SPAN),
                   key=lambda e: e[2])
    starts = [s[2] for s in spans]
    span_device: Dict[str, float] = {}
    span_kernels: Dict[str, Dict[str, float]] = {}
    for name, _, a, b in device:
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(starts, mid) - 1
        # spans of one level tile a frame; the latest start holding mid wins
        while j >= 0 and spans[j][3] < mid:
            j -= 1
        if j < 0:
            continue
        sname = spans[j][0]
        span_device[sname] = span_device.get(sname, 0.0) + (b - a)
        per = span_kernels.setdefault(sname, {})
        per[name] = per.get(name, 0.0) + (b - a)

    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    mids = [0.5 * (a + b) for a, b in gaps]
    host = [e for e in events if e[1] == "host"]
    span_at = _innermost(spans, mids)
    host_at = _innermost(host, mids)
    by_gap: Dict[str, float] = {}
    for (a, b), s, h in zip(gaps, span_at, host_at):
        label = f"{(s or FRAME_SPAN)[len(SPAN_PREFIX):]}/{h or 'python'}"
        by_gap[label] = by_gap.get(label, 0.0) + (b - a)

    return dict(
        frames=len(frames),
        window_us=w1 - w0,
        busy_us=sum(b - a for a, b in busy),
        launches=sum(1 for e in device if is_kernel(e[0])),
        by_name=by_name,
        span_device_us=span_device,
        span_kernels_us=span_kernels,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(by_gap.items(), key=lambda kv: -kv[1])[:top],
    )


def device_us_matching(folded: Dict, pattern: str, span: Optional[str] = None) -> float:
    """Device time of the operations whose name contains ``pattern``, in
    the whole window or inside ``span`` (``rtbench.<span>``)."""
    table = folded.get("by_name", {}) if span is None else \
        folded.get("span_kernels_us", {}).get(SPAN_PREFIX + span, {})
    return sum(us for name, us in table.items() if pattern in name)


def profiler_events(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile`` as tuples,
    from the raw kineto records where this PyTorch has them, else from
    ``prof.events()``."""
    from torch.autograd import DeviceType

    out: List[Event] = []
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None and hasattr(raw, "events"):
        for e in raw.events():
            name = e.name()
            if name.startswith("["):
                continue
            if hasattr(e, "start_ns"):
                a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
            else:
                a = e.start_us()
                b = a + e.duration_us()
            out.append((name, _kind(name, e.device_type() == DeviceType.CUDA), a, b))
        return out
    for e in prof.events():
        out.append((e.name, _kind(e.name, e.device_type == DeviceType.CUDA),
                    e.time_range.start, e.time_range.end))
    return out


def _kind(name: str, on_device: bool) -> str:
    if on_device:
        return "device"
    return "span" if name.startswith(SPAN_PREFIX) else "host"
