"""8-wide BVH: the collapse of a binary BVH into 8-entry rows, and the "fat"
rows that inline each leaf's pair.

Port of ``tpu_raytracing/bvh/wide.py`` (``WIDE``, ``WideBVH``,
``_frontier``, ``build_wide``, ``FatWideBVH``, ``ENTRY_WORDS``,
``build_wide_fat``, ``_expand_group``). Every Box slot's 3-level frontier
(up to 8 descendants, stopping early at leaves) is computed at once;
anchors are the Box slots whose depth is the root frontier's depth plus a
multiple of 3 (depth by 7 pointer-doubling passes), numbered by a prefix
sum; each anchor packs one [64] int32 row of 8 entries (box bits, meta,
pad). Rows are int32 with float bits cast in, so they compare bit for bit
with the reference's.

Meta word: child << 5 | count << 2 | type, with child a wide-node id for
Box entries and a pair index for Tri entries.

``build_wide_fat`` gathers the pair rows of all 8 entries in one [W, 8, 16]
gather; the reference gathers one entry at a time to dodge a TPU tiling
cost that the card does not have.

``collapse_fat`` is ``build_wide_fat`` behind K6's stack-depth check, as the
app's wide tracer runs it: on CPU tensors those two functions, on the card
the collapse kernels (``csrc/wide_collapse.cu``), bit-equal to
``build_wide_fat``, with one host read.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpu_raytracing_torch.bvh.types import BVH, CHILD_BOX, CHILD_NONE, CHILD_TRI
from tpu_raytracing_torch.ops import _cuda_build
from tpu_raytracing_torch.trace.traverse import f2i

WIDE = 8
ENTRY_WORDS = 24
_F32_MAX = float(torch.finfo(torch.float32).max)
# collapses run by the collapse kernels in this process: collapse_fat adds one
# where it launches them and nowhere else
launch_count = 0


@dataclasses.dataclass
class WideBVH:
    rows: torch.Tensor  # [W, 64] int32 — 8 entries x (min3, max3 bitcast, meta, pad)
    num_nodes: torch.Tensor  # [] int64 — live wide nodes (root = 0)


@dataclasses.dataclass
class FatWideBVH:
    """Wide BVH with each Tri entry's packed pair inlined: per row the 64
    node words, then entry 0..7's 16 pair words (v0..v3 bitcast, prim0,
    prim1, rot0, rot1; zeros for non-Tri entries). ``live_rows`` is
    ``num_nodes`` as read on the host by the builder that made the rows."""

    rows: torch.Tensor  # [W, 64 + 8 * 16] int32
    num_nodes: torch.Tensor  # [] int64
    live_rows: int


def _frontier(bvh: BVH) -> torch.Tensor:
    """3-level frontier of every Box slot: [N, 8] binary-slot ids, -1 holes.
    Level 1 is the slot's own child pair; levels 2 and 3 expand Box entries
    in place (leaves ride along, so a leaf's early stop leaves holes)."""
    n = bvh.num_slots
    ntype = bvh.type.to(torch.int64)
    child = bvh.child.to(torch.int64)
    is_box = ntype == CHILD_BOX
    entries = torch.stack([torch.where(is_box, child, -1), torch.where(is_box, child + 1, -1)],
                          dim=1)
    for _ in range(2):
        w = entries.shape[1]
        s = entries.clamp(0, n - 1)
        expand = (entries >= 0) & (ntype[s] == CHILD_BOX)
        left = torch.where(expand, child[s], entries)
        right = torch.where(expand, child[s] + 1, -1)
        entries = torch.stack([left, right], dim=2).reshape(n, 2 * w)
    return entries


def _expand_group(bvh: BVH, entries: torch.Tensor, levels: int) -> torch.Tensor:
    """Expand an [8] entry set ``levels`` times within the 8-slot budget,
    greedily from the left (Box entries past the budget stay as they are)."""
    n = bvh.num_slots
    ntype = bvh.type.to(torch.int64)
    child = bvh.child.to(torch.int64)
    for _ in range(levels):
        s = entries.clamp(0, n - 1)
        valid = entries >= 0
        is_box_e = valid & (ntype[s] == CHILD_BOX)
        count = valid.sum()
        order = torch.cumsum(is_box_e.to(torch.int64), 0)
        can = is_box_e & (count + order <= WIDE)
        outs = torch.where(can, 2, valid.to(torch.int64))
        starts = torch.cumsum(outs, 0) - outs
        c = child[s]
        new = torch.full((WIDE,), -1, dtype=torch.int64, device=entries.device)
        keep = valid & (starts < WIDE)
        new[starts[keep]] = torch.where(can, c, entries)[keep]
        keep = can & (starts + 1 < WIDE)
        new[starts[keep] + 1] = (c + 1)[keep]
        entries = new
    return entries


def _pack_entries(bvh: BVH, entries: torch.Tensor, wid_of_slot: torch.Tensor) -> torch.Tensor:
    """[..., 8] binary-slot ids (-1 empty) -> [..., 64] int32 rows."""
    n = bvh.num_slots
    s = entries.clamp(0, n - 1)
    valid = entries >= 0
    t = torch.where(valid, bvh.type.to(torch.int64)[s], CHILD_NONE)
    child = torch.where(t == CHILD_BOX, wid_of_slot[s], bvh.child.to(torch.int64)[s])
    count = bvh.count.to(torch.int64)[s]
    meta = ((child.clamp(min=0) << 5) | (count.clamp(0, 7) << 2) | t.clamp(0, 3)).to(torch.int32)
    nmin = torch.where(valid[..., None], bvh.node_min[s], _F32_MAX)
    nmax = torch.where(valid[..., None], bvh.node_max[s], -_F32_MAX)
    row = torch.cat([f2i(nmin), f2i(nmax), meta[..., None], torch.zeros_like(meta)[..., None]],
                    dim=-1)  # [..., 8, 8]
    return row.reshape(*row.shape[:-2], WIDE * 8)


def build_wide(bvh: BVH) -> WideBVH:
    """Collapse a binary BVH to 8-wide rows: row 0 is the root group's
    expansion, row 1 + k the k-th anchor's frontier, and the rows past
    ``num_nodes`` are zeros (type None)."""
    n = bvh.num_slots
    dev = bvh.child.device
    rc = int(bvh.root_count)
    slot_ids = torch.arange(WIDE, dtype=torch.int64, device=dev)
    root_entries = torch.where(slot_ids < rc, int(bvh.root) + slot_ids, -1)
    # a pair root reaches 8 entries in 2 expansions, a single root in 3;
    # the anchor depths below must match
    base = 2 if rc == 2 else 3
    root_frontier = _expand_group(bvh, root_entries, levels=base)

    slots = torch.arange(n, dtype=torch.int64, device=dev)
    anc = bvh.parent.to(torch.int64)
    depth = (anc != slots).to(torch.int64)
    for _ in range(7):  # tree depth <= 64: 7 doublings saturate
        depth = depth + depth[anc]
        anc = anc[anc]
    anchor = (bvh.type == CHILD_BOX) & (depth >= base) & ((depth - base) % 3 == 0)
    a64 = anchor.to(torch.int64)
    rank = torch.cumsum(a64, 0) - a64
    wid_of_slot = torch.where(anchor, 1 + rank, -1)
    num_wide = 1 + a64.sum()

    rows = torch.zeros((n + 1, WIDE * 8), dtype=torch.int32, device=dev)
    rows[0] = _pack_entries(bvh, root_frontier, wid_of_slot)
    anchors = torch.nonzero(anchor).reshape(-1)
    rows[1 + rank[anchors]] = _pack_entries(bvh, _frontier(bvh)[anchors], wid_of_slot)
    return WideBVH(rows=rows, num_nodes=num_wide)


def build_wide_fat(bvh: BVH, pair_rows: torch.Tensor) -> FatWideBVH:
    """Collapse to 8-wide with inlined pair data (``pair_rows``:
    ``PackedPairs.rows``)."""
    w = build_wide(bvh)
    rows = w.rows.reshape(-1, WIDE, 8)
    meta = rows[:, :, 6]
    child = (meta >> 5).to(torch.int64).clamp(0, pair_rows.shape[0] - 1)
    pe = pair_rows[child]  # [W, 8, 16]
    pe = torch.where(((meta & 3) == CHILD_TRI)[..., None], pe, 0)
    fat = torch.cat([w.rows, pe.reshape(-1, WIDE * 16)], dim=1)
    return FatWideBVH(rows=fat, num_nodes=w.num_nodes, live_rows=int(w.num_nodes))


def collapse_fat(bvh: BVH, pair_rows: torch.Tensor) -> FatWideBVH:
    """``build_wide_fat(bvh, pair_rows)`` after K6's stack-depth check
    (``ops/fat_traverse.py:check_stack_depth``): the rows the wide tracer
    traces. CPU tensors run those two functions; CUDA tensors launch the
    collapse kernels (``csrc/wide_collapse.cu``: the depth and anchor pass, a
    scan, the row emit), bit-equal to ``build_wide_fat`` with ``num_nodes``
    left on the card, and read the live row count, the depth and
    ``root_count`` back in one copy, or raise. Either way the live row count
    comes back read, as ``live_rows``. A tree deeper than K6's stack
    covers raises ``check_stack_depth``'s ValueError; so do ``pair_rows``
    other than a contiguous [P >= 1, 16] int32 tensor and, on the card,
    fields of other types or devices than ``BVH`` declares."""
    from tpu_raytracing_torch.ops import fat_traverse  # it imports this module
    global launch_count
    if (pair_rows.dtype != torch.int32 or pair_rows.dim() != 2 or pair_rows.shape[0] < 1
            or pair_rows.shape[1] != 16 or not pair_rows.is_contiguous()):
        raise ValueError(f"collapse_fat: pair_rows must be a contiguous [P >= 1, 16] int32 "
                         f"tensor, not {pair_rows.dtype} {tuple(pair_rows.shape)}"
                         f"{'' if pair_rows.is_contiguous() else ' (non-contiguous)'}")
    dev = bvh.child.device
    if dev.type == "cpu":
        fat_traverse.check_stack_depth(bvh)
        return build_wide_fat(bvh, pair_rows)
    fields = (bvh.node_min, bvh.node_max, bvh.child, bvh.count, bvh.type, bvh.parent,
              bvh.root, bvh.root_count, pair_rows)
    types = (torch.float32,) * 2 + (torch.int32,) * 7
    n = bvh.num_slots
    if (dev.type != "cuda" or n < 1 or pair_rows.data_ptr() % 16
            or any(x.device != dev or x.dtype != t for x, t in zip(fields, types))):
        raise ValueError(f"collapse_fat: a BVH of {n} slots on {dev} with fields of other types "
                         f"or devices than BVH declares, or pair_rows not 16-byte aligned")
    node_min, node_max, child, count, ntype, parent = (x.contiguous() for x in (
        bvh.node_min, bvh.node_max, bvh.child, bvh.count, bvh.type, bvh.parent))
    lib = _cuda_build.load_library("wide_collapse")
    depth_fn, emit_fn = lib.wide_collapse_depth_launch, lib.wide_collapse_emit_launch
    depth_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    emit_fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64, ctypes.c_void_p,
                                                   ctypes.c_void_p, ctypes.c_int64,
                                                   ctypes.c_void_p])
    depth_fn.restype = emit_fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the stack covers L = (STACK - 1) // 7 wide levels: row 0's 2 or 3
    # binary levels and 3 more a row, so a walk that reaches 3 L + 1 links
    # fails the check for either root group
    cap = 3 * ((fat_traverse.STACK - 1) // 7) + 1
    info = torch.zeros((3,), dtype=torch.int64, device=dev)  # live rows, depth, root_count
    flag = torch.empty((n,), dtype=torch.int32, device=dev)
    err = depth_fn(parent.data_ptr(), ntype.data_ptr(), bvh.root_count.data_ptr(),
                   flag.data_ptr(), info.data_ptr(), n, cap, stream)
    if err != 0:
        raise RuntimeError(f"wide_collapse depth kernel launch failed: cudaError {err}")
    incl = torch.cumsum(flag, 0, dtype=torch.int32)
    rows = torch.empty((n + 1, WIDE * ENTRY_WORDS), dtype=torch.int32, device=dev)
    err = emit_fn(node_min.data_ptr(), node_max.data_ptr(), child.data_ptr(), count.data_ptr(),
                  ntype.data_ptr(), flag.data_ptr(), incl.data_ptr(), bvh.root.data_ptr(),
                  bvh.root_count.data_ptr(), pair_rows.data_ptr(), pair_rows.shape[0],
                  rows.data_ptr(), info.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"wide_collapse emit kernel launch failed: cudaError {err}")
    launch_count += 1
    live_rows, depth, root_count = info.tolist()
    if depth >= cap:  # the walk stopped at cap: the exact depth for the error
        depth = fat_traverse.binary_depth(bvh)
    fat_traverse.check_depth(depth, root_count)
    return FatWideBVH(rows=rows, num_nodes=info[0], live_rows=live_rows)
