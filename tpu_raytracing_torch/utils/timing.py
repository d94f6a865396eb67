"""Per-stage timing and the frame-rate counter (reference: the run()
macro, src/Common.cuh:369-388, and ComputeFPS, src/main.cu:194-213).

Port of ``tpu_raytracing/utils/timing.py`` (``StageTimer``,
``FPSCounter``). Where the reference waits with ``jax.block_until_ready``,
a stage here synchronises the CUDA device of its result's tensors; on the
CPU, where PyTorch runs synchronously, there is nothing to wait for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch


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
        """Times the ``with`` block; set ``out["value"]`` to the block's
        result to wait for its device work."""
        start = time.perf_counter()
        out = {}
        yield out
        if out.get("value") is not None:
            block_until_ready(out["value"])
        self._record(name, start)

    def run(self, name: str, fn, *args, **kwargs):
        """Time ``fn`` including device completion; returns its result."""
        start = time.perf_counter()
        result = block_until_ready(fn(*args, **kwargs))
        self._record(name, start)
        return result

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, ms in self.stages:
            out[name] = out.get(name, 0.0) + ms
        return out


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
