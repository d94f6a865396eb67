"""SAH-quality trees for the split tracer (K1).

Port of ``tpu_raytracing/bvh/split_convert.py`` (``_setup``, ``_split_cap``,
``build_sah_split``, which also stands for ``build_sah_split_auto``: the
port has one frontier form, ``bvh/sah.py``; ``check_sah_split_capacity``,
``_emit_from_arena``), bit-equal to it, and ``sah_split_views``: K1's
views of an SAH tree (``bucket.split_views``) with the tree's own stack
bound.

The binned-SAH frontier (``bvh/sah.py``) realises every partition with one
stable sort of the whole primitive axis keyed by (task, bin), so a node's
subtree occupies a contiguous range of the final leaf permutation.
Reordering the pair array by that permutation makes every subtree a
contiguous pair range: a terminal entry stores its subtree's window start,
and K1 intersects the fixed-width window [start, start + leaf_width).

The collapse to 8-wide rows uses depth arithmetic: a Box slot at depth 3k
(k >= 1) whose subtree holds more than ``leaf_width`` pairs anchors a row,
and a row's entries are its descendants three levels down, stopping early
at any entry whose subtree fits a window (that entry becomes a Tri
window).

An SAH tree may be deeper than the bucket tree's stack bound allows for
(``bucket.stack_cap``), so its views carry their own bound, from the
emitted tree's depth in rows.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from tpu_raytracing_torch.bvh import sah
from tpu_raytracing_torch.bvh.bucket import SplitBVH, _empty_entry, split_views
from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_NONE, CHILD_TRI
from tpu_raytracing_torch.trace.traverse import _META_CHILD_SHIFT, PackedPairs, f2i, pack_pairs

_F32_MAX = float(torch.finfo(torch.float32).max)
WIDE = 8
# K1's largest stack (csrc/split_trace.cu: kMaxStack).
MAX_STACK = 256


def _split_cap(n: int, leaf_width: int) -> int:
    """Rows bound: a live anchor's subtree holds > leaf_width pairs and
    anchors of one depth class are disjoint; ~2n/k bounds nodes with >= k
    descendants across all classes."""
    return max(4 * n // max(leaf_width, 1), 256) + 64


def build_sah_split(triangles: torch.Tensor, enable_pairs: bool = False, leaf_width: int = 64,
                    enable_splits: bool = False, deadline: float = None, debug: bool = False,
                    stats: Optional[dict] = None) -> Tuple[SplitBVH, PackedPairs]:
    """Binned-SAH build emitting the split format: one global SAH frontier
    over the leaves (pairs and spatial splits optional), then
    ``_emit_from_arena``. With ``enable_splits`` the sorted pair array
    carries one row per reference, duplicates included: each window row is
    real geometry, so duplicates only re-test.

    ``deadline`` (``time.monotonic()``) bounds the frontier
    (``sah.SahDeadlineExceeded``); ``debug`` runs the build invariants. A
    ``stats`` dict gets each stage's seconds (``setup_s``, ``frontier_s``,
    ``emit_s``; the device is synchronised between stages), the frontier's
    ``levels``, the arena's ``tree_depth`` and the ``deepest_anchor``'s
    depth.
    """
    dev = triangles.device
    clock = [time.perf_counter()]

    def lap(key):
        if stats is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            stats[key] = now - clock[0]
            clock[0] = now

    leaves, pairs = sah._setup(triangles, enable_pairs, enable_splits)
    lap("setup_s")
    cap = leaves.aabb_min.shape[0]
    arena = sah.make_arena(2 * cap + 2, track_segments=True, device=dev)
    arena.wptr = torch.ones((), dtype=torch.int64, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    arena, ids_final = sah.frontier_build(
        leaves, arena, zero, leaves.num_leaves.reshape(1).to(torch.int32), zero, 1,
        return_ids=True, deadline=deadline, debug=debug, stats=stats)
    lap("frontier_s")
    out = _emit_from_arena(arena, ids_final, leaves, pairs, leaf_width)
    lap("emit_s")
    if stats is not None:
        n = arena.num_slots
        depth = arena.depth[:n]
        stats["tree_depth"] = int(depth.max())
        stats["deepest_anchor"] = int(torch.where(_anchors(arena, leaf_width), depth, 0).max())
    return out


def _anchors(arena: sah.Arena, leaf_width: int) -> torch.Tensor:
    """The arena slots that anchor an inner row: Box slots at depth 3k
    (k >= 1) whose subtree holds more than ``leaf_width`` pairs."""
    n = arena.num_slots
    depth = arena.depth[:n]
    return ((arena.type[:n] == CHILD_BOX) & (arena.seg_count[:n] > leaf_width)
            & (depth >= 3) & (depth % 3 == 0))


def check_sah_split_capacity(split: SplitBVH) -> None:
    """Host guard for the emission: anchor rows whose slot 1 + rank lands
    past ICAP are dropped, which would silently truncate the traced tree."""
    ni = int(split.num_inner)
    icap = int(split.inner.shape[0])
    if not 0 < ni <= icap:
        raise RuntimeError(
            f"SAH split emit overflow: num_inner {ni} outside (0, {icap}] "
            f"— anchor rows were dropped; raise _split_cap")
    if int(split.num_leaves) <= 0:
        raise RuntimeError("SAH split emit produced no live leaves")


def _emit_from_arena(arena: sah.Arena, ids_final, leaves: sah.LeafInput, pairs,
                     leaf_width: int) -> Tuple[SplitBVH, PackedPairs]:
    """SplitBVH emission from a finished SAH arena (see build_sah_split)."""
    cap = leaves.aabb_min.shape[0]
    num_leaves = leaves.num_leaves
    nslots = arena.num_slots
    dev = arena.child.device

    # --- pair array in final leaf order (zero the padded tail) ---
    packed = pack_pairs(pairs)
    pid_sorted = leaves.child[ids_final.to(torch.int64).clamp(0, cap - 1)].to(torch.int64)
    live = torch.arange(cap, device=dev) < num_leaves
    rows_sorted = torch.where(live[:, None],
                              packed.rows[pid_sorted.clamp(0, packed.rows.shape[0] - 1)], 0)

    # --- per-slot subtree (start, count) and depth, recorded by the frontier
    child = arena.child[:nslots].to(torch.int64)
    is_box = arena.type[:nslots] == CHILD_BOX
    counts = arena.seg_count[:nslots].to(torch.int64)
    starts = torch.where(counts > 0, arena.seg_start[:nslots].to(torch.int64), cap)
    grows = is_box & (counts > leaf_width)
    anchor = _anchors(arena, leaf_width)
    a64 = anchor.to(torch.int64)
    rank = torch.cumsum(a64, 0) - a64
    wid_of_slot = torch.where(anchor, 1 + rank, -1)
    num_inner = 1 + a64.sum()

    # --- frontier with early window termination: entry e of a row is the
    # descendant reached by child-bit path (e>>2, (e>>1)&1, e&1) ---
    def stepb(entries, bit):
        s = entries.clamp(0, nslots - 1)
        nxt = (child[s] + bit).clamp(0, nslots - 1)
        grow = (entries >= 0) & grows[s]
        return torch.where(grow, nxt, entries if bit == 0 else -1)

    base = [torch.where(grows, child.clamp(0, nslots - 1), -1),
            torch.where(grows, (child + 1).clamp(0, nslots - 1), -1)]
    ent = torch.stack([stepb(stepb(base[e >> 2], (e >> 1) & 1), e & 1)
                       for e in range(WIDE)], dim=1)  # [N, 8]
    root0 = torch.zeros((1,), dtype=torch.int64, device=dev)
    root_ent = torch.stack([stepb(stepb(stepb(root0, e >> 2), (e >> 1) & 1), e & 1)
                            for e in range(WIDE)], dim=1)  # [1, 8]
    win_max = torch.clamp(num_leaves - leaf_width, min=0)

    def pack(entries):
        s = entries.clamp(0, nslots - 1)
        valid = entries >= 0
        term = valid & ~grows[s]
        starts_s = starts[s]
        win = torch.minimum(starts_s, win_max).clamp(0, cap - 1)
        ch = torch.where(term, win, torch.clamp(wid_of_slot[s], min=0))
        etype = torch.where(term, CHILD_TRI, torch.where(valid, CHILD_BOX, CHILD_NONE))
        meta = torch.where(valid, ((ch << _META_CHILD_SHIFT) | etype).to(torch.int32), 0)
        nmin = torch.where(valid[..., None], arena.node_min[s], _F32_MAX)
        nmax = torch.where(valid[..., None], arena.node_max[s], -_F32_MAX)
        row = torch.cat([f2i(nmin), f2i(nmax), meta[..., None], torch.zeros_like(meta)[..., None]],
                        dim=-1)
        # per-entry subtree (start, count) in the final leaf permutation:
        # what refit_split refreshes boxes from
        er = torch.stack([torch.where(valid, starts_s, 0), torch.where(valid, counts[s], 0)],
                         dim=-1).to(torch.int32)
        return row.reshape(row.shape[:-2] + (WIDE * 8,)), er

    icap = _split_cap(cap, leaf_width)
    empty_row = _empty_entry(dev).repeat(WIDE)
    inner = empty_row.repeat(icap + 1, 1)  # row icap: the trash row
    e_ranges = torch.zeros((icap + 1, WIDE, 2), dtype=torch.int32, device=dev)
    all_rows, all_er = pack(ent)
    dest = torch.where(anchor & (1 + rank < icap), 1 + rank, icap)
    inner[dest] = all_rows
    e_ranges[dest] = all_er
    inner, e_ranges = inner[:icap], e_ranges[:icap]

    # Root row: slot 0's expansion; a scene whose root subtree fits one
    # window gets a single-Tri row covering it.
    root_row, root_er = (x[0] for x in pack(root_ent))
    root_small = ~grows[0]
    leaf_meta = (((torch.minimum(starts[0], win_max).clamp(0, cap - 1)) << _META_CHILD_SHIFT)
                 | CHILD_TRI).to(torch.int32)
    leaf_row = torch.cat([f2i(arena.node_min[0]), f2i(arena.node_max[0]), leaf_meta[None],
                          torch.zeros((1,), dtype=torch.int32, device=dev),
                          _empty_entry(dev).repeat(WIDE - 1)])
    leaf_er = torch.zeros((WIDE, 2), dtype=torch.int32, device=dev)
    leaf_er[0, 1] = num_leaves.to(torch.int32)
    inner[0] = torch.where(root_small, leaf_row, root_row)
    e_ranges[0] = torch.where(root_small, leaf_er, root_er)

    split = SplitBVH(inner=inner, num_inner=num_inner, num_leaves=num_leaves,
                     leaf_width=leaf_width, e_ranges=e_ranges)
    return split, PackedPairs(rows=rows_sorted)


def row_depth(inner: torch.Tensor, num_inner: int) -> int:
    """Rows on the longest root-to-leaf path of a split tree (1 for a root
    row of windows only), walking Box entries level by level from row 0."""
    icap = inner.shape[0]
    meta = inner.reshape(icap, -1, 8)[..., 6]
    rows = torch.zeros((1,), dtype=torch.int64, device=inner.device)
    levels = 0
    while rows.numel():
        levels += 1
        if levels > num_inner:
            raise RuntimeError("split tree rows form a cycle")
        m = meta[rows]
        rows = (m[(m & 3) == CHILD_BOX] >> _META_CHILD_SHIFT).to(torch.int64)
    return levels


def sah_stack_cap(levels: int, w: int = WIDE) -> int:
    """K1's stack bound for a tree ``levels`` rows deep: a pop at row level
    l (root 0) finds at most (w - 1) * l entries below it, each ancestor
    leaving at most w - 1, and pushes at most w. Capped at K1's MAX_STACK:
    a ray that would need more sets its overflow flag and stops, and
    ``path_trace`` raises."""
    return min((w - 1) * (levels - 1) + w, MAX_STACK)


def sah_split_views(split: SplitBVH, packed: PackedPairs):
    """K1's views of an SAH split tree: ((inner [ICAP, 8, 8] i32, pairs
    [P_pad, 16] i32, stack_cap), packed, split), ``bucket.split_views``
    with the tree's own stack bound from its depth in rows."""
    cap = sah_stack_cap(row_depth(split.inner, int(split.num_inner)))
    return split_views(split, packed, cap), packed, split
