"""Per-stage timing, the frame-rate counter (reference: the run()
macro, src/Common.cuh:369-388, and ComputeFPS, src/main.cu:194-213), and
the program's spans and counters.

Port of ``tpu_raytracing/utils/timing.py`` (``StageTimer``,
``FPSCounter``). Where the reference waits with ``jax.block_until_ready``,
a stage here synchronises the CUDA device of its result's tensors; on the
CPU, where PyTorch runs synchronously, there is nothing to wait for.

Spans and counters (``span``, ``count``, ``count_max``, ``recorded``,
``clear``) record
exactly while a ``torch.profiler`` session records; otherwise a span
costs one flag read. A span opens a host range in the profiler's trace
(``_RecordFunctionFast``: a ``cpu_op`` with no annotation on the device,
so the trace's device operations stay the program's kernels), keeps its
name, parent and host clock in this module's record and, once CUDA is
initialised, a pair of timing events on the current stream. The record
is one per process and not thread-safe: the program traces from one
thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

# the profiler's host range with no device-side annotation; without it
# (an older PyTorch) the spans are kept in the record alone
_HOST_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)
# spans kept before the record drops new ones (and counts them)
MAX_SPANS = 1 << 20
# device scalars one counter keeps before summing them into one
_COUNTER_FOLD = 4096


class _Record:
    """The process's spans and counters, and its pool of CUDA events."""

    def __init__(self):
        self.pool: list = []
        self.spans: list = []
        self.clear()

    def clear(self) -> None:
        for s in self.spans:
            if s[4] is not None:
                self.pool += s[4:6]
        # [name, parent index or None, t0 ns, t1 ns, start event, end event]
        self.spans = []
        self.open: list = []
        # name -> [Python sum, device scalars]
        self.counters: Dict[str, list] = {}
        # name -> [Python maximum, device scalars]
        self.maxima: Dict[str, list] = {}
        self.dropped = 0
        self.result: Optional[dict] = None

    def event(self):
        return self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)


_RECORD = _Record()
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether spans and counters record: while a ``torch.profiler``
    session records."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "index", "host", "stream")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _RECORD
        rec.result = None
        self.host = None if _HOST_RANGE is None else _HOST_RANGE(self.name)
        if self.host is not None:
            self.host.__enter__()
        if len(rec.spans) >= MAX_SPANS:
            rec.dropped += 1
            self.index = None
        else:
            self.index = len(rec.spans)
            start = end = None
            if torch.cuda.is_initialized():
                # both events on the stream the span starts on (fetching the
                # current stream costs as much as recording an event)
                self.stream = torch.cuda.current_stream()
                start, end = rec.event(), rec.event()
                start.record(self.stream)
            rec.spans.append([self.name, rec.open[-1] if rec.open else None,
                              time.perf_counter_ns(), None, start, end])
        rec.open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = _RECORD
        rec.result = None
        rec.open.pop()
        if self.index is not None:
            s = rec.spans[self.index]
            if s[5] is not None:
                s[5].record(self.stream)
            s[3] = time.perf_counter_ns()
        if self.host is not None:
            self.host.__exit__(*exc)
        return False


def span(name: str):
    """A context manager: the span ``name`` around its block while
    ``tracing()``, else a shared no-op. Its parent is the innermost span
    open when it opens."""
    return _Span(name) if _profiler._is_profiler_enabled else _OFF


def spanned(name: str):
    """Decorator: the function's calls run inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, value) -> None:
    """Adds ``value`` (a Python number or a device scalar) to the counter
    ``name`` while ``tracing()``. Device scalars of one name share a
    dtype; they are summed when read."""
    if not _profiler._is_profiler_enabled:
        return
    rec = _RECORD
    rec.result = None
    c = rec.counters.setdefault(name, [0, []])
    if isinstance(value, torch.Tensor):
        c[1].append(value.reshape(()))
        if len(c[1]) >= _COUNTER_FOLD:
            c[1] = [torch.stack(c[1]).sum()]
    else:
        c[0] += value


def count_max(name: str, value) -> None:
    """Keeps the largest ``value`` (a Python number or a device scalar)
    given to the counter ``name`` while ``tracing()``; read as one number
    beside the summed counters."""
    if not _profiler._is_profiler_enabled:
        return
    rec = _RECORD
    rec.result = None
    c = rec.maxima.setdefault(name, [None, []])
    if isinstance(value, torch.Tensor):
        c[1].append(value.reshape(()))
        if len(c[1]) >= _COUNTER_FOLD:
            c[1] = [torch.stack(c[1]).max()]
    else:
        c[0] = value if c[0] is None else max(c[0], value)


def recorded() -> dict:
    """The record since the last ``clear()``, after one synchronise:
    ``spans``, a list of dicts (``name``, ``parent``: the parent's index in
    the list or None, ``host_ms``, ``device_ms``: the CUDA-event time from
    the stream reaching the span to its finishing it, None without CUDA or
    while the span is open), ``counters`` (name -> Python number: the sum
    of a ``count`` counter, the largest value of a ``count_max`` one) and
    ``dropped`` (spans past ``MAX_SPANS``)."""
    rec = _RECORD
    if rec.result is not None:
        return rec.result
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    spans = []
    for name, parent, t0, t1, start, end in rec.spans:
        closed = t1 is not None
        spans.append(dict(name=name, parent=parent,
                          host_ms=(t1 - t0) / 1e6 if closed else None,
                          device_ms=(start.elapsed_time(end)
                                     if closed and start is not None else None)))
    counters = {name: total + (torch.stack(dev).sum().item() if dev else 0)
                for name, (total, dev) in rec.counters.items()}
    for name, (top, dev) in rec.maxima.items():
        values = ([] if top is None else [top]) + ([torch.stack(dev).max().item()] if dev else [])
        counters[name] = max(values)
    rec.result = dict(spans=spans, counters=counters, dropped=rec.dropped)
    return rec.result


def clear() -> None:
    """Empties the record (its CUDA events go back to the pool)."""
    _RECORD.clear()


def _tensors(value):
    """The tensors in ``value``: a tensor, or a tuple, list, dict or
    dataclass of them (nested)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name))


def block_until_ready(value):
    """Wait for the CUDA devices that hold ``value``'s tensors; returns
    ``value``."""
    for dev in {t.device for t in _tensors(value) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return value


class StageTimer:
    """Collects named stage timings; prints like the reference when enabled."""

    def __init__(self, should_print: bool = False):
        self.should_print = should_print
        self.stages: List[tuple] = []

    def _record(self, name: str, start: float) -> None:
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        self.stages.append((name, elapsed_ms))
        if self.should_print:
            # Same line format as the reference's run() macro.
            print(f"{name} time elapsed: {elapsed_ms:f}ms")

    @contextlib.contextmanager
    def stage(self, name: str):
        """Times the ``with`` block, inside ``span(name.strip())``; set
        ``out["value"]`` to the block's result to wait for its device
        work."""
        start = time.perf_counter()
        out = {}
        with span(name.strip()):
            yield out
            if out.get("value") is not None:
                block_until_ready(out["value"])
        self._record(name, start)

    def run(self, name: str, fn, *args, **kwargs):
        """Time ``fn`` including device completion, inside
        ``span(name.strip())``; returns its result."""
        start = time.perf_counter()
        with span(name.strip()):
            result = block_until_ready(fn(*args, **kwargs))
        self._record(name, start)
        return result


class FPSCounter:
    """Adaptive-window FPS counter (reference: ComputeFPS, src/main.cu:194-213)."""

    def __init__(self):
        self.frame_count = 0
        self.fps_limit = 1
        self.last = time.perf_counter()
        self.fps: Optional[float] = None

    def tick(self) -> Optional[float]:
        self.frame_count += 1
        if self.frame_count >= self.fps_limit:
            now = time.perf_counter()
            elapsed = now - self.last
            self.fps = self.frame_count / elapsed if elapsed > 0 else None
            # Adapt the averaging window toward ~1 report/second.
            if self.fps:
                self.fps_limit = max(1, int(self.fps))
            self.frame_count = 0
            self.last = now
        return self.fps
