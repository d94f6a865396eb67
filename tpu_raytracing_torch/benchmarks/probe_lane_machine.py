"""Feasibility probes of a per-lane traversal machine, on the H100.

Port of ``benchmarks/probe_lane_machine.py``: 128 rays on the 128 threads
of one CTA (``csrc/lane_probe.cu``), each advancing on its own, the
tables in shared memory:

  e1       per-lane gather along the lanes of an (8, 128) table
  e1b      the same on a (96, 128) table, one index per lane
  e1c      a dependent chain of e1b gathers: gather -> use -> next index
  e2       the same chain through a one-hot bf16 product (float32 sums)
  e3       per-lane variable shift of a (32, 128) stack by static rolls and
           selects, as a chain; e3_once is one shift (the correctness kernel)
  e4       per-lane gather along the rows (axis 0) of a (32, 128) table
  e5       the full per-lane body mock: gather, slab, rank, stack shift

Chains run ITERS dependent iterations (environment, default 4,096). The
reference's TPU times describe the TPU only.

    python -m tpu_raytracing_torch.benchmarks.probe_lane_machine [--device cpu]
"""

from __future__ import annotations

import torch

from tpu_raytracing_torch.benchmarks import _common, _lane

KINDS = ("e1", "e1b", "e1c", "e2", "e3", "e3_once", "e4", "e5")
CHAINS = ("e1c", "e2", "e3", "e5")
REFERENCE = "benchmarks/probe_lane_machine.py"
SOURCE = "tpu_raytracing_torch/csrc/lane_probe.cu"
# The reference's pallas_call sites: line in benchmarks/probe_lane_machine.py.
REPLACES = {"e1": 63, "e1b": 84, "e1c": 111, "e2": 138, "e3": 168, "e3_once": 182, "e4": 202,
            "e5": 261}
TITLES = {"e1": "E1 lane-gather (8,128) axis=1", "e1b": "E1b lane-gather (96,128) axis=1 bcast idx",
          "e1c": "E1c dependent lane-gather chain (96,128)",
          "e2": "E2 dependent one-hot bf16 matmul chain (96,128)",
          "e3": "E3 stack shift (32,128) chain", "e3_once": "E3 roll-select variable shift",
          "e4": "E4 sublane-gather (32,128) axis=0",
          "e5": "E5 full per-lane body mock (fetch+slab+rank+stack)"}

# Launches of each probe's kernel since the count was last set to 0: the
# wrapper adds one where it launches the kernel and nowhere else.
launch_count = {k: 0 for k in KINDS}


def _chain_e1c(tab, idx0, iters):
    out = idx0.to(torch.float32)
    for _ in range(iters):
        out = _common.remainder(_lane.gather(tab, _lane.lane_ptr(out[0])) + 1.0, 127.0)
    return out


def _chain_e2(tab, idx0, iters):
    tabf = tab.to(torch.float32)
    k = torch.arange(_lane.LANES, device=tab.device)[:, None]
    out = idx0.to(torch.float32)
    for _ in range(iters):
        onehot = (k == _lane.lane_ptr(out[0])[None, :]).to(torch.float32)  # (128 el, 128 lane)
        g = (tabf[:, :, None] * onehot[None, :, :]).sum(1)
        out = _common.remainder(g + 1.0, 127.0)
    return out


def _chain_e3(st, k, iters):
    out = st.clone()
    for i in range(iters):
        out = _lane.roll_select(out, (k[0].to(torch.int64) + i) & 7) + 1.0
    return out


def _chain_e5(tab, idx0, iters):
    out = idx0.to(torch.float32)
    st = torch.zeros((_lane.S, _lane.LANES), dtype=torch.float32, device=tab.device)
    for _ in range(iters):
        g = _lane.gather(tab, _lane.lane_ptr(out[0]))
        nvalid, _ = _lane.slab(g)
        st = _lane.stack_push(st, torch.clamp(nvalid, max=7), 0.0)
        out = _common.remainder(g + 1.0, 127.0)
    return out, st


def probe_plain(kind: str, tab, idx, iters: int):
    """The plain PyTorch version: (out, final stack or None)."""
    if kind == "e1":
        return tab[torch.arange(8, device=tab.device)[:, None], idx.clamp(0, 127).long()], None
    if kind == "e1b":
        return _lane.gather(tab, idx[0].long()), None
    if kind == "e1c":
        return _chain_e1c(tab, idx, iters), None
    if kind == "e2":
        return _chain_e2(tab, idx, iters), None
    if kind == "e3":
        return _chain_e3(tab, idx, iters), None
    if kind == "e3_once":
        return _lane.roll_select(tab, idx[0].to(torch.int64) & 7), None
    if kind == "e4":
        lanes = torch.arange(_lane.LANES, device=tab.device)
        return tab[idx.clamp(0, _lane.S - 1).long(), lanes[None, :]], None
    if kind == "e5":
        return _chain_e5(tab, idx, iters)
    raise ValueError(f"unknown probe {kind!r}; one of {KINDS}")


def probe(kind: str, tab, idx, iters: int = _lane.ITERS_DEFAULT):
    """Probe ``kind`` on the reference's operands (see ``inputs``); chains
    run ``iters`` iterations. Returns (out float32, e5's final stack
    [32, 128] or None). CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    rows = {"e1": 8, "e3": _lane.S, "e3_once": _lane.S, "e4": _lane.S}.get(kind, _lane.ROWS)
    return _common.dispatch(
        KINDS, launch_count, kind, tab.device, lambda: probe_plain(kind, tab, idx, iters),
        lambda: _lane.launch(kind, tab, idx, rows, _lane.S if kind == "e5" else 0, iters))


def library(kind: str, tab, idx, iters: int = _lane.ITERS_DEFAULT):
    """The same function through PyTorch's own calls, where they compute
    it: one take_along_dim for the gathers and the one shift; for e2, the
    chain of ``iters`` steps, each a one-hot product by torch.matmul (bf16
    out: exact for these integers below 127) and remainder(g + 1, 127)
    feeding the next. None otherwise."""
    if kind == "e1":
        return torch.take_along_dim(tab, idx.long(), dim=1)
    if kind == "e1b":
        return torch.take_along_dim(tab, idx.long().expand(_lane.ROWS, -1), dim=1)
    if kind == "e3_once":
        src = (torch.arange(_lane.S, device=tab.device)[:, None] - (idx.long() & 7)) % _lane.S
        return torch.take_along_dim(tab, src, dim=0)
    if kind == "e4":
        return torch.take_along_dim(tab, idx.long(), dim=0)
    if kind == "e2":
        k = torch.arange(_lane.LANES, device=tab.device)[:, None]
        out = idx.to(torch.float32)
        for _ in range(iters):
            onehot = (k == (out[0].long() & 127)).to(torch.bfloat16)
            out = torch.remainder(torch.matmul(tab, onehot).float() + 1.0, 127.0)
        return out
    return None


def inputs(kind: str, seed: int, device):
    """(tab, idx) of the reference's shapes and dtypes, from a numpy seed."""
    t = _lane.rng_tables(seed, device)
    rng = t["rng"]
    f = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    if kind == "e1":
        return (torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128),
                f(rng.integers(0, 128, (8, 128)).astype("int32")))
    if kind == "e1b":
        return t["normal"], f(rng.integers(0, 128, (1, 128)).astype("int32"))
    if kind in ("e1c", "e5"):
        return t["int127"], t["idx0"]
    if kind == "e2":
        return t["int127"].to(torch.bfloat16), t["idx0"]
    if kind in ("e3", "e3_once"):
        return t["normal"][:_lane.S].contiguous(), f(rng.integers(0, 8, (1, 128)).astype("int32"))
    if kind == "e4":
        return t["normal"][:_lane.S].contiguous(), f(rng.integers(0, 32, (32, 128)).astype("int32"))
    raise ValueError(f"unknown probe {kind!r}; one of {KINDS}")


def main(argv=None) -> dict:
    """Runs every probe, timed (median of 5 runs, float inputs + (run % 3)
    as in the reference); where ``library`` computes the same function, the
    kernel's output on the first inputs is held to it (``ok``). Returns
    ``_common.entry_point``'s results."""
    def line(kind, ms, ns, ok):
        head = f"{TITLES[kind]}: " + ("" if ok is None else f"ok={ok}, ")
        return f"{head}{ms!r} ms total, " + (f"{ns:.1f} ns/iter" if kind in CHAINS else "one shot")
    return _common.entry_point(
        argv, "tpu_raytracing_torch.benchmarks.probe_lane_machine", "ITERS", _lane.ITERS_DEFAULT,
        KINDS, probe, lambda kind, iters, dev: _lane.arg_sets(inputs(kind, 0, dev), iters),
        lambda kind, iters: iters if kind in CHAINS else 1, line,
        lambda kind, *a: _lane.matches_library(probe, library, kind, *a))


if __name__ == "__main__":
    main()
