"""Per-pop cost components of a traversal loop, on the H100.

Port of ``benchmarks/micro_pallas.py``: five N-iteration loops on one CTA
(``csrc/micro_probe.cu``), each adding one component to the last:

  loop   scalar-only body: s += idx_of(i, seed)
  dma1   + one 512 B row copy, global -> shared memory, per iteration
         (pseudo-random row), issued and waited on before the row is read
  dma2   + a second 4 KB (8, 128) window copy per iteration
  comp   dma1 + 54 float32 operations on each element of an (8, 128) tile
  pipe4  dma1 with 4 copies in flight, round-robin

Every loop's output is the int32 sum of ``rows[idx_of(i, seed)][6]`` (of
``idx_of`` for ``loop``); ``comp`` also returns its final tile. ns/iter
tells which component dominates a pop. The reference's TPU times describe
the TPU only.

    python -m tpu_raytracing_torch.benchmarks.micro_pallas [--device cpu]

``N`` (environment, default 200,000) sets the loop length.
"""

from __future__ import annotations

import torch

from tpu_raytracing_torch.benchmarks import _common, _micro

KINDS = ("loop", "dma1", "dma2", "comp", "pipe4")
N_DEFAULT = 200_000
REFERENCE = "benchmarks/micro_pallas.py"
SOURCE = "tpu_raytracing_torch/csrc/micro_probe.cu"
# The reference's kernels: file:line.
REPLACES = {"loop": 67, "dma1": 75, "dma2": 88, "comp": 109, "pipe4": 130}
# float32 operations per element of comp's (8, 128) tile per iteration:
# 6 x (mul, add, max, mul, sub, min) + 6 x (mul, min, add)
COMP_OPS = 54

# Launches of each probe's kernel since the count was last set to 0: the
# wrapper adds one where it launches the kernel and nowhere else.
launch_count = {k: 0 for k in KINDS}


def _comp_tile(acc: torch.Tensor, n: int) -> torch.Tensor:
    x = acc.clone()
    for _ in range(n):
        for _ in range(6):
            x = torch.maximum(x * 1.0001 + 0.5, x)
            x = torch.minimum(x * 0.9999 - 0.5, x)
        for _ in range(6):
            x = x + torch.minimum(x, 0.25 * x)
    return x


def probe_plain(kind: str, rows, seed, n: int, fill: dict):
    """The plain PyTorch version: (out [1] int32, comp's final tile or None)."""
    i = _micro.loop_index(n, rows.device)
    idx = _common.idx_of(i, int(seed[0]))
    out = _micro.sum32(idx if kind == "loop" else rows[idx, 6])
    return out, (_comp_tile(fill["acc"], n) if kind == "comp" else None)


def probe(kind: str, rows, seed, n: int, fill: dict = None):
    """Probe ``kind`` over ``rows`` [65536, 128] int32 with ``seed`` [1]
    int32 for ``n`` iterations; ``fill`` holds the scratch the kernel reads
    before writing (comp's tile; interpret mode's NaN by default). Returns
    (out [1] int32, comp's final tile [8, 128] or None). CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    fill = _micro.interpret_fills(rows.device) if fill is None else fill

    def launch():
        out, acc = _micro.launch(kind, rows, seed, n, fill)
        return out, (acc if kind == "comp" else None)
    return _common.dispatch(KINDS, launch_count, kind, rows.device,
                            lambda: probe_plain(kind, rows, seed, n, fill), launch)


def work(kind: str, seed: int, n: int):
    """(float32 operations, bytes) the probe must do and move: the rows it
    copies (each distinct row once), the seed in, the result out."""
    if kind == "loop":
        return 0.0, 8
    idx = _common.idx_of(_micro.loop_index(n + (4 if kind == "pipe4" else 0), "cpu"), seed)
    rows = set(idx.unique().tolist())
    if kind == "dma2":
        start = torch.clamp(idx, max=_common.W - 8)
        rows |= set((start[:, None] + torch.arange(8)).unique().tolist())
    nbytes = 8 + 512 * len(rows)
    if kind == "comp":
        return float(n) * 8 * 128 * COMP_OPS, nbytes + 2 * 8 * 128 * 4
    return 0.0, nbytes


def main(argv=None) -> dict:
    """Times every probe (median of 5 runs, seed and scratch varied per
    run) and prints ns/iter; returns ``_common.entry_point``'s results."""
    return _common.entry_point(
        argv, "tpu_raytracing_torch.benchmarks.micro_pallas", "N", N_DEFAULT, KINDS,
        probe, _micro.arg_sets, lambda kind, n: n,
        lambda kind, ms, ns, ok: f"{kind:<5}: {ns:.1f} ns/iter ({ms!r} ms)")


if __name__ == "__main__":
    main()
