"""The fixed per-iteration overhead of the per-lane machine, on the H100.

Port of ``benchmarks/probe_lane_machine3.py``, on one CTA
(``csrc/lane_probe.cu``):

  V0  probe 2's chain with the state fed back through the output tile
  V1  the state in a dedicated (8, 128) int32 tile, read whole
  V2  V1 + the full body (slab, rank, stack shift)
  V3  V2 with 2 independent packets interleaved (reported per packet-iter)
  V4  V2 in chunks of 8 iterations inside an any-alive loop whose
      condition is a CTA-wide sum (the real kernel's termination)

ITERS (environment, default 4,096) sets the loop length. The reference's
TPU times describe the TPU only.

    python -m tpu_raytracing_torch.benchmarks.probe_lane_machine3 [--device cpu]
"""

from __future__ import annotations

import torch

from tpu_raytracing_torch.benchmarks import _common, _lane

KINDS = ("V0", "V1", "V2", "V3", "V4")
REFERENCE = "benchmarks/probe_lane_machine3.py"
SOURCE = "tpu_raytracing_torch/csrc/lane_probe.cu"
# The reference's pallas_call site: line in benchmarks/probe_lane_machine3.py.
REPLACES = {k: 120 for k in KINDS}

# Launches of each probe's kernel since the count was last set to 0: the
# wrapper adds one where it launches the kernel and nowhere else.
launch_count = {k: 0 for k in KINDS}


def packets(kind: str) -> int:
    return 2 if kind == "V3" else 1


def _step(kind, tab, ptr8, st):
    g = _lane.gather(tab, (ptr8[0] & 127).long())
    if kind != "V1":
        nvalid, rank0 = _lane.slab(g)
        st = _lane.stack_push(st, torch.clamp(nvalid, max=7), rank0.to(torch.float32))
    ptr8 = _common.wrap32(ptr8.to(torch.int64) + _common.f2i(g[0:8]) + 1) & 127
    return ptr8, st


def probe_plain(kind: str, tab, idx, iters: int):
    """The plain PyTorch version: (out, final stacks [npk * 32, 128] or None)."""
    if kind == "V0":
        out = idx.to(torch.float32)
        for _ in range(iters):
            out = _common.remainder(_lane.gather(tab, _lane.lane_ptr(out[0])) + 1.0, 127.0)
        return out, None
    if kind not in KINDS:
        raise ValueError(f"unknown probe {kind!r}; one of {KINDS}")
    npk = packets(kind)
    st8 = [_common.wrap32(idx[0:8].to(torch.int64) + p) for p in range(npk)]
    st = [torch.zeros((_lane.S, _lane.LANES), dtype=torch.float32, device=tab.device)
          for _ in range(npk)]
    steps = 8 * (iters // 8) if kind == "V4" else iters  # V4: ITERS // 8 chunks of 8
    for _ in range(steps):
        for p in range(npk):
            st8[p], st[p] = _step(kind, tab, st8[p], st[p])
    rows = [s.to(torch.float32) for s in st8]
    rows.append(torch.zeros((_lane.ROWS - 8 * npk, _lane.LANES), dtype=torch.float32,
                            device=tab.device))
    return torch.cat(rows), (None if kind == "V1" else torch.cat(st))


def probe(kind: str, tab, idx, iters: int = _lane.ITERS_DEFAULT):
    """Probe ``kind`` on tab [96, 128] float32 and idx0 [96, 128] int32 for
    ``iters`` iterations. Returns (out [96, 128] float32, the final stacks
    [npk * 32, 128] for V2-V4 or None). CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    stack_rows = 0 if kind in ("V0", "V1") else packets(kind) * _lane.S
    return _common.dispatch(KINDS, launch_count, kind, tab.device,
                            lambda: probe_plain(kind, tab, idx, iters),
                            lambda: _lane.launch(kind, tab, idx, _lane.ROWS, stack_rows, iters))


def inputs(kind: str, seed: int, device):
    """(tab, idx0) of the reference's shapes and dtypes, from a numpy seed."""
    t = _lane.rng_tables(seed, device)
    return t["int100"], t["idx0"]


def main(argv=None) -> dict:
    """Times every variant (median of 5 runs, float inputs
    + (run % 3) as in the reference); prints ns per packet-iteration.
    Returns ``_common.entry_point``'s results, iters counting
    packet-iterations."""
    return _common.entry_point(
        argv, "tpu_raytracing_torch.benchmarks.probe_lane_machine3", "ITERS", _lane.ITERS_DEFAULT,
        KINDS, probe, lambda kind, iters, dev: _lane.arg_sets(inputs(kind, 0, dev), iters),
        lambda kind, iters: iters * packets(kind),
        lambda kind, ms, ns, ok: f"{kind}: {ms!r} ms, {ns:.1f} ns/packet-iter")


if __name__ == "__main__":
    main()
