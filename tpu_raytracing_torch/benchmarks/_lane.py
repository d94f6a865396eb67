"""The per-lane machine probes' kernel (``csrc/lane_probe.cu``), its
launch, and the pieces of the plain versions that the three lane-probe
modules share. Every array is the reference's (rows, 128) tile: column l
is lane l."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_raytracing_torch.benchmarks import _common

# The order of csrc/lane_probe.cu's Kind.
KINDS = ("e1", "e1b", "e1c", "e2", "e3", "e3_once", "e4", "e5", "full", "fetch", "fetch2",
         "nofetch", "full2x", "wide", "V0", "V1", "V2", "V3", "V4")
LANES = 128
ROWS = 96
S = 32
ITERS_DEFAULT = 4096
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def launch(kind: str, tab, idx, out_rows: int, stack_rows: int, iters: int,
           table_lanes: int = LANES):
    """One launch of the lane kernel ``kind`` on CUDA tensors: ``tab``
    float32 (bfloat16 for e2) and ``idx`` int32, both contiguous. Returns
    (out [out_rows, 128] float32, final stack [stack_rows, 128] or None)."""
    want = torch.bfloat16 if kind == "e2" else torch.float32
    _common.require_cuda_operands(f"lane probe {kind}", {
        "tab": (tab, want, tab.shape), "idx": (idx, torch.int32, idx.shape)})
    if idx.numel() < LANES or idx.device != tab.device:
        raise ValueError(f"lane probe {kind}: idx {tuple(idx.shape)} on {idx.device}")
    dev = tab.device
    out = torch.empty((out_rows, LANES), dtype=torch.float32, device=dev)
    extra = torch.empty((max(stack_rows, 1), LANES), dtype=torch.float32, device=dev)
    fn = _common.kernel_fn("lane_probe", "lane_probe_launch", _ARGTYPES)
    err = fn(KINDS.index(kind), tab.data_ptr(), idx.data_ptr(), out.data_ptr(), extra.data_ptr(),
             iters, table_lanes, _common.stream_of(tab))
    if err != 0:
        raise RuntimeError(f"lane_probe kernel {kind} launch failed: cudaError {err}")
    return out, (extra if stack_rows else None)


def lane_ptr(state_row: torch.Tensor, lanes: int = LANES) -> torch.Tensor:
    """Row 0 of a float32 state tile as each lane's pointer:
    ``astype(int32) & (lanes - 1)``."""
    return (_common.f2i(state_row) & (lanes - 1)).to(torch.int64)


def gather(tab: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """take_along_axis(tab, broadcast(ptr), axis=1): g[s, l] = tab[s, ptr[l]]."""
    return tab[:, ptr.clamp(0, tab.shape[1] - 1)]


def roll_select(st: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each lane's column rolled down by k & 7: three static rolls along the
    rows (by 4, 2, 1) and selects, as the reference shifts its stack."""
    for bit in (4, 2, 1):
        st = torch.where((k & bit) != 0, torch.roll(st, bit, 0), st)
    return st


def slab(g: torch.Tensor):
    """The mock slab test on box = g[0:48] as (6, 8, 128): per lane, the
    entries' hit count and the rank of entry 0's key among the 8."""
    box = g[0:48].reshape(6, 8, LANES)
    t0 = (box[0] - 0.3) * box[3]
    t1 = (box[1] - 0.2) * box[4]
    t2 = (box[2] - 0.1) * box[5]
    front = torch.maximum(torch.maximum(torch.minimum(t0, t1), torch.minimum(t1, t2)),
                          torch.minimum(t0, t2))
    back = torch.minimum(torch.minimum(torch.maximum(t0, t1), torch.maximum(t1, t2)),
                         torch.maximum(t0, t2))
    hit = back >= front
    key = torch.where(hit, front, torch.tensor(3e38, dtype=torch.float32, device=g.device))
    rank0 = (key < key[0:1]).sum(0)
    return hit.sum(0), rank0


def stack_push(st: torch.Tensor, k: torch.Tensor, add) -> torch.Tensor:
    """The stack shifted by k, then (st + add) + 1 on the rows below k."""
    st = roll_select(st, k)
    sub = torch.arange(st.shape[0], device=st.device)[:, None]
    return torch.where(sub < k, (st + add) + 1.0, st)


def rng_tables(seed: int, device):
    """numpy-seeded inputs of the reference's shapes and dtypes: an integer
    table in [0, 100) and [0, 127), a normal table, index tiles."""
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return dict(
        int100=f(rng.integers(0, 100, (ROWS, LANES)).astype(np.float32)),
        int127=f(rng.integers(0, 127, (ROWS, LANES)).astype(np.float32)),
        normal=f(rng.normal(size=(ROWS, LANES)).astype(np.float32)),
        idx0=f(rng.integers(0, LANES, (ROWS, LANES)).astype(np.int32)),
        rng=rng)


def vary(t: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's per-run input change: float inputs + (k % 3)."""
    return t if t.dtype == torch.int32 else (t + (k % 3)).contiguous()


def arg_sets(tab_idx: tuple, iters: int) -> list:
    """The entry points' argument sets for ``probe(kind, ...)``: (tab +
    (k % 3), idx, iters) for k = 0 (warm-up) to REPS."""
    tab, idx = tab_idx
    return [(vary(tab, k), idx, iters) for k in range(_common.REPS + 1)]


def matches_library(probe, library, kind: str, tab, idx, iters: int):
    """Whether the probe's output equals ``library``'s, or None where the
    module has no library call for ``kind``."""
    lib = library(kind, tab, idx, iters)
    return None if lib is None else bool(torch.equal(probe(kind, tab, idx, iters)[0], lib))


def bank_profile(ptrs: torch.Tensor):
    """How a row-major gather of ``ptrs`` [steps, 128] (each step's column
    per lane) falls on shared memory's 32 banks: the mean number of distinct
    columns a warp reads per row, and the mean conflict degree (the most
    distinct columns of one bank in a warp's read: 1 is conflict-free, 4
    the most a 128-column table allows)."""
    occ = torch.zeros((ptrs.shape[0], LANES // 32, LANES), dtype=torch.int64)
    occ.scatter_(2, ptrs.long().reshape(-1, LANES // 32, 32), 1)
    per_bank = occ.reshape(ptrs.shape[0], LANES // 32, LANES // 32, 32).sum(2)
    return float(occ.sum(2).double().mean()), float(per_bank.max(2).values.double().mean())


def pointer_walk(tab: torch.Tensor, ptr0: torch.Tensor, iters: int, relative: bool = False):
    """The lanes' columns over ``iters`` steps of a chain whose pointer is
    row 0 of what it gathered, plus 1: ``p -> (tab[0, p] + 1) & 127``, or
    with ``relative`` ``p -> (p + tab[0, p] + 1) & 127`` (the V kernels'
    state). Returns [iters, 128] int64."""
    row0 = tab[0].detach().to("cpu", torch.float32).long()
    p = ptr0.detach().to("cpu").long() & (LANES - 1)
    out = torch.empty((iters, LANES), dtype=torch.int64)
    for t in range(iters):
        out[t] = p
        p = ((p if relative else 0) + row0[p] + 1) & (LANES - 1)
    return out


# float32 operations per lane and iteration (conversions, integer work and
# selects on ints not counted): the mock slab is 8 entries x (3 sub, 3 mul,
# 10 min/max, a compare, a select), the rank of entry 0 is 8 compares, a
# stack push is 2 adds on each of 32 rows, each output row 1 add (and 1
# remainder in the chains that take one). E2's one-hot products (a multiply
# and an add for each of 128 entries of each of 96 rows) are bf16 products
# with float32 sums: tensor-core work, counted apart.
_SLAB, _RANK, _PUSH = 8 * 18, 8, 2 * S
OPS_PER_LANE_ITER = {
    "e1c": 2 * ROWS, "V0": 2 * ROWS, "e2": 2 * ROWS, "e3": S,
    "e5": _SLAB + _PUSH + 2 * ROWS, "full": _SLAB + _RANK + _PUSH + ROWS, "fetch": ROWS,
    "fetch2": 3 * ROWS + ROWS, "nofetch": 2 + ROWS + _SLAB + _RANK + _PUSH + ROWS,
    "full2x": _SLAB + _RANK + 2 * _PUSH + ROWS, "V1": 8, "V2": 8 + _SLAB + _RANK + _PUSH,
    "V3": 2 * (8 + _SLAB + _RANK + _PUSH), "V4": 8 + _SLAB + _RANK + _PUSH}
BF16_OPS_PER_LANE_ITER = {"e2": ROWS * 2 * LANES}


def work(kind: str, tab, idx, out_rows: int, stack_rows: int, iters: int):
    """(float32 operations, bf16 tensor-core operations, bytes) a lane
    probe must do and move: each input read once, the output and the final
    stack written once, the operations of ``OPS_PER_LANE_ITER`` and
    ``BF16_OPS_PER_LANE_ITER`` over 128 lanes and the iterations run (V4:
    ITERS // 8 chunks of 8); the one-shot gathers only move bytes."""
    nbytes = (tab.numel() * tab.element_size() + idx.numel() * 4
              + (out_rows + stack_rows) * LANES * 4)
    steps = LANES * (8 * (iters // 8) if kind == "V4" else iters)
    return (float(OPS_PER_LANE_ITER.get(kind, 0)) * steps,
            float(BF16_OPS_PER_LANE_ITER.get(kind, 0)) * steps, nbytes)
