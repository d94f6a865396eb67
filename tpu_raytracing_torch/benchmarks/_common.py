"""What the probe modules share: JAX's integer and float semantics that the
plain versions need, the scratch fill of Pallas interpret mode, device
and card handling, kernel calls through ctypes, and the timer."""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import time
from typing import Callable, List, Sequence

import torch

from tpu_raytracing_torch.ops import _cuda_build

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1
# rows of the scalar probes' table: arange(W * 128) as [W, 128] int32
W = 65536


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around, as JAX's int32
    arithmetic wraps."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def idx_of(i: torch.Tensor, seed: int) -> torch.Tensor:
    """The reference's row hash ``((i * 7919 + seed) * 1103515245 &
    0x7FFFFFFF) % W`` with int32 wrap-around, on int64 tensors: the low 31
    bits of the product depend only on the low 32 bits of its factors."""
    x = (i.to(torch.int64) * 7919 + int(seed)) & 0xFFFFFFFF
    return ((x * 1103515245) & 0x7FFFFFFF) % W


def f2i(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: toward zero, saturating, NaN -> 0
    (the same as CUDA's ``cvt.rzi.s32.f32``; a plain ``.to(torch.int32)``
    is undefined outside the range)."""
    t = torch.nan_to_num(x.to(torch.float64).trunc(), nan=0.0)
    return t.clamp(INT32_MIN, INT32_MAX).to(torch.int32)


def remainder(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.remainder`` on float32: C ``fmod``, moved into the divisor's
    sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def interpret_fill(shape, dtype: torch.dtype, device="cpu") -> torch.Tensor:
    """What Pallas interpret mode leaves in scratch a kernel reads before
    writing it: NaN for float32, INT32_MIN for int32 (pinned by the CPU
    tests). On the TPU its contents are undefined."""
    if dtype == torch.float32:
        return torch.full(shape, float("nan"), dtype=dtype, device=device)
    if dtype == torch.int32:
        return torch.full(shape, INT32_MIN, dtype=dtype, device=device)
    raise ValueError(f"no interpret-mode fill known for {dtype}")


def device_of(name: str) -> torch.device:
    """The device a probe's entry point runs on; ``cuda`` without a card
    raises (there is no quiet CPU run)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on the card "
                           "(--device cpu runs the plain versions)")
    return torch.device(name)


def card_label(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or a CPU label."""
    if device.type != "cuda":
        return "cpu, plain PyTorch versions"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


# Timed runs per probe in the entry points; each reports their median.
REPS = 5


def parse_args(argv, prog: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


# Cycles of the spin kernel queued ahead of a timed call (~2 ms on an H100,
# some 20x the host's work in a probe's wrapper).
SPIN_CYCLES = 4_000_000


def _event_ms(fn: Callable, args: tuple, window: bool) -> float:
    """CUDA events around ``fn(*args)``. Unless ``window``, the events and
    the call are queued behind a spin kernel (``torch.cuda._sleep``) that
    keeps the card busy while the host checks operands, allocates and
    launches, so the window holds the call's device work only; a spin that
    ended before the host had queued everything is run again, twice as
    long."""
    spin = SPIN_CYCLES
    while True:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if not window:
            torch.cuda._sleep(spin)
        start.record()
        fn(*args)
        end.record()
        late = not window and start.query()
        torch.cuda.synchronize()
        if not late:
            return start.elapsed_time(end)
        spin *= 2


def time_runs(fn: Callable, arg_sets: Sequence[tuple], device: torch.device,
              window: bool = False) -> List[float]:
    """``fn(*arg_sets[0])`` once to warm up, then each later argument set
    timed on its own: on the card by ``_event_ms`` (with ``window``, the
    host's gaps count: a chain of many launches, where they are part of the
    cost), on the CPU by the host clock. Returns the ms of each timed
    run."""
    fn(*arg_sets[0])
    times = []
    for args in arg_sets[1:]:
        if device.type == "cuda":
            times.append(_event_ms(fn, args, window))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def dispatch(kinds: Sequence[str], launch_count: dict, kind: str, device: torch.device,
             plain: Callable, launch: Callable):
    """Every probe wrapper's skeleton: an unknown ``kind`` raises, CPU
    tensors take ``plain()``, CUDA tensors ``launch()`` the kernel, which
    adds one to ``launch_count[kind]``."""
    if kind not in kinds:
        raise ValueError(f"unknown probe {kind!r}; one of {tuple(kinds)}")
    if device.type == "cpu":
        return plain()
    res = launch()
    launch_count[kind] += 1
    return res


def entry_point(argv, module: str, size_var: str, size_default: int, kinds: Sequence[str],
                probe: Callable, arg_sets: Callable, steps: Callable, line: Callable,
                check: Callable = None) -> dict:
    """The probe modules' ``main``: ``--device`` (``cuda`` unless ``cpu``),
    the size from the environment variable ``size_var``, then for each kind
    ``probe(kind, *args)`` over ``arg_sets(kind, size, device)`` (a warm-up
    set and REPS timed ones), ``check(kind, *first set)`` (True / False /
    None), and one printed ``line(kind, ms, ns per step, ok)`` with the
    card's label. ``steps(kind, size)`` counts a run's steps. Returns {kind:
    {"ms" (median), "runs", "iters", "ns_per_iter", "ok"}}."""
    args = parse_args(argv, f"python -m {module}")
    dev = device_of(args.device)
    size = env_int(size_var, size_default)
    label = card_label(dev)
    print(f"device: {dev}, {size_var}={size}  [{label}]", flush=True)
    results = {}
    for kind in kinds:
        sets = arg_sets(kind, size, dev)
        ok = None if check is None else check(kind, *sets[0])
        runs = time_runs(lambda *a: probe(kind, *a), sets, dev)
        ms = statistics.median(runs)
        n = steps(kind, size)
        results[kind] = dict(ms=ms, runs=runs, iters=n, ns_per_iter=ms * 1e6 / n, ok=ok)
        print(f"{line(kind, ms, ms * 1e6 / n, ok)}  [{label}]", flush=True)
    return results


def kernel_fn(lib_name: str, fn_name: str, argtypes: list):
    """A C entry point of ``csrc/<lib_name>.cu`` (built at first use)."""
    fn = getattr(_cuda_build.load_library(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_operands(what: str, tensors: dict) -> None:
    """Every operand on one CUDA device, contiguous, of its dtype and
    shape; ``tensors`` maps name -> (tensor, dtype, shape)."""
    dev = None
    for name, (t, dtype, shape) in tensors.items():
        dev = dev or t.device
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} {tuple(shape)} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
