"""The per-iteration cost structure of the per-lane machine, on the H100.

Port of ``benchmarks/probe_lane_machine2.py``: E5's loop skeleton (state
fed back through the output tile, ITERS iterations) on one CTA
(``csrc/lane_probe.cu``), each variant adding or removing one piece:

  full     gather + slab + rank + stack shift (E5 with the rank pushed)
  fetch    the gather alone
  fetch2   two gathers (at ptr and ptr ^ 1)
  nofetch  full with a static slice in place of the gather
  full2x   full with the body work twice

and ``wide_gather_check``: the gather from a table 256 or 512 lanes wide
(``wide256``, ``wide512``), one shot. ITERS (environment, default 4,096)
sets the loop length. The reference's TPU times describe the TPU only.

    python -m tpu_raytracing_torch.benchmarks.probe_lane_machine2 [--device cpu]
"""

from __future__ import annotations

import torch

from tpu_raytracing_torch.benchmarks import _common, _lane

KINDS = ("full", "fetch", "fetch2", "nofetch", "full2x", "wide256", "wide512")
BODIES = ("full", "fetch", "fetch2", "nofetch", "full2x")
WIDE = {"wide256": 256, "wide512": 512}
REFERENCE = "benchmarks/probe_lane_machine2.py"
SOURCE = "tpu_raytracing_torch/csrc/lane_probe.cu"
# The reference's pallas_call sites: line in benchmarks/probe_lane_machine2.py.
REPLACES = {**{k: 85 for k in BODIES}, "wide256": 107, "wide512": 107}
STACKED = ("full", "nofetch", "full2x")

# Launches of each probe's kernel since the count was last set to 0: the
# wrapper adds one where it launches the kernel and nowhere else.
launch_count = {k: 0 for k in KINDS}


def _body_plain(kind, tab, idx0, iters):
    lanes = tab.shape[1]
    out = idx0.to(torch.float32)
    st = torch.zeros((_lane.S, _lane.LANES), dtype=torch.float32, device=tab.device)
    for _ in range(iters):
        ptr = _lane.lane_ptr(out[0], lanes)
        if kind == "nofetch":
            g = tab[:, 0:128] * (1.0 + ptr.to(torch.float32) * 0.0)
        else:
            g = _lane.gather(tab, ptr)
            if kind == "fetch2":
                g2 = _lane.gather(tab, ptr ^ 1)
                g = g + g2 * 0.0 + g2
        if kind in STACKED:
            nvalid, rank0 = _lane.slab(g)
            for r in range(2 if kind == "full2x" else 1):
                st = _lane.stack_push(st, torch.clamp(nvalid + r, max=7), rank0.to(torch.float32))
        out = g + 1.0
    return out, (st if kind in STACKED else None)


def probe_plain(kind: str, tab, idx, iters: int):
    """The plain PyTorch version: (out, final stack or None)."""
    if kind in WIDE:
        return _lane.gather(tab, idx[0, :_lane.LANES].long()), None
    if kind in BODIES:
        return _body_plain(kind, tab, idx, iters)
    raise ValueError(f"unknown probe {kind!r}; one of {KINDS}")


def probe(kind: str, tab, idx, iters: int = _lane.ITERS_DEFAULT):
    """Probe ``kind``: the bodies on tab [96, 128] float32 and idx0
    [96, 128] int32 for ``iters`` iterations; the wide gathers on tab
    [96, 256 | 512] and idx [1, 256 | 512]. Returns (out [96, 128] float32,
    the final stack [32, 128] for full/nofetch/full2x or None). CPU tensors
    run the plain version; CUDA tensors launch the kernel or raise."""
    def launch():
        if kind in WIDE:
            if tab.shape != (_lane.ROWS, WIDE[kind]):
                raise ValueError(f"{kind}: tab must be [96, {WIDE[kind]}], got {tuple(tab.shape)}")
            return _lane.launch("wide", tab, idx, _lane.ROWS, 0, 0, WIDE[kind])
        return _lane.launch(kind, tab, idx, _lane.ROWS, _lane.S if kind in STACKED else 0, iters)
    return _common.dispatch(KINDS, launch_count, kind, tab.device,
                            lambda: probe_plain(kind, tab, idx, iters), launch)


def library(kind: str, tab, idx, iters: int = _lane.ITERS_DEFAULT):
    """take_along_dim for the wide gathers; None for the bodies."""
    if kind not in WIDE:
        return None
    return torch.take_along_dim(tab, idx.long().expand(_lane.ROWS, -1), dim=1)[:, :_lane.LANES]


def inputs(kind: str, seed: int, device):
    """(tab, idx) of the reference's shapes and dtypes, from a numpy seed."""
    t = _lane.rng_tables(seed, device)
    if kind in BODIES:
        return t["int100"], t["idx0"]
    lanes = WIDE[kind]
    rng = t["rng"]
    return (torch.as_tensor(rng.normal(size=(_lane.ROWS, lanes)).astype("float32"), device=device),
            torch.as_tensor(rng.integers(0, lanes, (1, lanes)).astype("int32"), device=device))


# Lane layouts for ``spread_inputs``: each lane's first column. "same": every
# lane reads one column (broadcasts); "distinct": 128 columns, a warp's 32 in
# 32 banks; "distinct4": 128 columns, a warp's 32 on 8 banks, 4 each (the
# most conflict a row-major 128-column table allows).
SPREADS = {"same": lambda l: 0 * l, "distinct": lambda l: l,
           "distinct4": lambda l: 4 * (l % 32) + l // 32}


def spread_inputs(spread: str, seed: int, device):
    """``fetch``'s inputs with the lanes' columns laid out as ``spread``
    says, in every iteration: row 0 of the table is p -> p + 1 (for
    "same": p -> p), which keeps distinct columns distinct and their banks
    as they started; the other rows as the reference's."""
    tab, idx = inputs("fetch", seed, device)
    tab, idx = tab.clone(), idx.clone()
    cols = torch.arange(_lane.LANES, device=device)
    tab[0] = (cols - (1 if spread == "same" else 0)).to(torch.float32) % _lane.LANES
    idx[0] = SPREADS[spread](cols).to(torch.int32)
    return tab, idx


def main(argv=None) -> dict:
    """Times every variant (median of 5 runs, float inputs + (run % 3) as in
    the reference) and holds the wide gathers to take_along_dim (``ok``).
    Returns ``_common.entry_point``'s results."""
    def line(kind, ms, ns, ok):
        if kind in WIDE:
            return f"wide lane-gather table_lanes={WIDE[kind]}: ok={ok}, {ms!r} ms"
        return f"{kind}: {ms!r} ms, {ns:.1f} ns/iter"
    return _common.entry_point(
        argv, "tpu_raytracing_torch.benchmarks.probe_lane_machine2", "ITERS", _lane.ITERS_DEFAULT,
        KINDS, probe, lambda kind, iters, dev: _lane.arg_sets(inputs(kind, 0, dev), iters),
        lambda kind, iters: 1 if kind in WIDE else iters, line,
        lambda kind, *a: _lane.matches_library(probe, library, kind, *a))


if __name__ == "__main__":
    main()
