"""The program's own spans and counters (``tpu_raytracing_torch/utils/
timing.py``: ``recorded()``), as the profiled stretch recorded them,
folded for the per-layer readers: self times by span name and parent
name, and counter totals, per profiled frame (``ctx["folded"]["frames"]``:
frames, or images in the modes cell).

A span's time is its device time where it has one (CUDA events: the
stream's time from reaching the span to finishing it, the device's idle
time inside it included), else its host time (the CPU, where PyTorch runs
synchronously). Its self time is that less its children's. Every reader
returns None where the program recorded nothing: a program without the
facility, or a run without the profiler.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple


def record() -> Optional[dict]:
    """The program's record, or None where it has none or it is empty."""
    try:
        from tpu_raytracing_torch.utils import timing
    except ImportError:
        return None
    recorded = getattr(timing, "recorded", None)
    if recorded is None:
        return None
    rec = recorded()
    return rec if rec["spans"] or rec["counters"] else None


def self_ms(rec: dict) -> Dict[Tuple[str, Optional[str]], float]:
    """Self ms summed by (span name, parent's name or None); spans still
    open when recorded are left out."""
    spans = rec["spans"]
    own = [s["device_ms"] if s["device_ms"] is not None else s["host_ms"] for s in spans]
    rest = list(own)
    for s, ms in zip(spans, own):
        p = s["parent"]
        if p is not None and ms is not None and rest[p] is not None:
            rest[p] -= ms
    out: Dict[Tuple[str, Optional[str]], float] = {}
    for s, ms in zip(spans, rest):
        if ms is not None:
            p = s["parent"]
            key = (s["name"], None if p is None else spans[p]["name"])
            out[key] = out.get(key, 0.0) + ms
    return out


def _frames(ctx) -> Optional[int]:
    folded = ctx.get("folded") or {}
    return folded.get("frames") or None


def stage_ms(ctx, names: Iterable[str], parents: Optional[Iterable[str]] = None,
             rec: Optional[dict] = None) -> Optional[float]:
    """Self ms per profiled frame of the spans named in ``names`` (whose
    parent is named in ``parents``, where given), or None where there is
    no such span."""
    rec = record() if rec is None else rec
    frames = _frames(ctx)
    if rec is None or frames is None:
        return None
    names = set(names)
    parents = None if parents is None else set(parents)
    hits = [ms for (n, p), ms in self_ms(rec).items()
            if n in names and (parents is None or p in parents)]
    return sum(hits) / frames if hits else None


def counters(prefix: str, rec: Optional[dict] = None) -> Dict[str, float]:
    """The counters whose name starts with ``prefix``, by name."""
    rec = record() if rec is None else rec
    if rec is None:
        return {}
    return {n: v for n, v in rec["counters"].items() if n.startswith(prefix)}
