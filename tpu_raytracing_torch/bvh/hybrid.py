"""Hybrid build: LBVH bottom, SAH-rebuilt top (reference:
src/BottomUpBuilder.cu:314-371 and src/BuildWrapper.cu:350-361).

Port of ``tpu_raytracing/bvh/hybrid.py`` (``EXTRACT_DEPTH``,
``MAX_SUBROOTS``, ``extract_depth``, ``build_hybrid``), bit-equal to it.

The LBVH's top levels are its weakest (Morton-order splits ignore surface
area), so the hybrid extracts the sub-tree root pairs at depth 8 and
rebuilds the tree above them with the binned-SAH frontier
(``bvh/sah.py:frontier_build``), grafting each sub-root pair as a Box leaf
of count 2. The frontier rewrites the grafted pairs' parent links to their
new parents, so the wide collapse's depth arithmetic runs through the
graft.

The reference's ExtractDepth walks 256 threads down bit paths with
atomicAdd compaction (nondeterministic order); here, as in the JAX
package, the walk is a breadth-first expansion of a fixed-size frontier
and the output is in BFS order, which is deterministic.

The result's root is one node appended after the LBVH's slots, with
``root_count`` 1; the LBVH's own top levels stay in the arena, unreachable.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_raytracing_torch.bvh import lbvh
from tpu_raytracing_torch.bvh.sah import Arena, LeafInput, frontier_build
from tpu_raytracing_torch.bvh.types import BVH, CHILD_BOX, CHILD_TRI, TrianglePairs

EXTRACT_DEPTH = 8  # the reference's target_depth (src/BuildWrapper.cu:354)
MAX_SUBROOTS = 1 << EXTRACT_DEPTH
# The empty box of the appended slots, as the reference writes it (not
# float32's max).
_EMPTY = 3.4e38


def extract_depth(bvh: BVH):
    """Collect the sub-tree root pairs at depth <= EXTRACT_DEPTH
    (src/BottomUpBuilder.cu:314-371).

    A pair stops descending early when either slot is a Tri leaf. Returns
    (pair_index [MAX_SUBROOTS] int32, -1 past the valid ones; aabb_min,
    aabb_max [MAX_SUBROOTS, 3], the union of each pair's two slots;
    valid_count).
    """
    n = MAX_SUBROOTS
    num_slots = bvh.num_slots
    dev = bvh.child.device
    child = bvh.child.to(torch.int64)
    ntype = bvh.type
    frontier = torch.full((n,), -1, dtype=torch.int64, device=dev)
    frontier[0] = bvh.root.to(torch.int64)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    for _ in range(EXTRACT_DEPTH):
        idx = frontier.clamp(0, num_slots - 1)
        idx1 = (idx + 1).clamp(0, num_slots - 1)
        is_leaf_pair = (ntype[idx] == CHILD_TRI) | (ntype[idx1] == CHILD_TRI)
        live = frontier >= 0
        stop = live & (done | is_leaf_pair)
        expand = live & ~stop
        counts = torch.where(stop, 1, torch.where(expand, 2, 0))
        starts = torch.cumsum(counts, 0) - counts

        def slot(mask, pos):
            # positions past the frontier are dropped: row n is the trash row
            return torch.where(mask & (pos < n), pos, n)

        keep_slot = slot(stop, starts)
        new = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
        new[keep_slot] = frontier
        new[slot(expand, starts)] = child[idx]
        new[slot(expand, starts + 1)] = child[idx1]
        new_done = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
        new_done[keep_slot] = True
        frontier, done = new[:n], new_done[:n]

    count = (frontier >= 0).sum()
    idx = frontier.clamp(0, num_slots - 1)
    idx1 = (idx + 1).clamp(0, num_slots - 1)
    amin = torch.minimum(bvh.node_min[idx], bvh.node_min[idx1])
    amax = torch.maximum(bvh.node_max[idx], bvh.node_max[idx1])
    return frontier.to(torch.int32), amin, amax, count


def build_hybrid(triangles: torch.Tensor, enable_pairs: bool = False) -> Tuple[BVH, TrianglePairs]:
    """LBVH build and SAH re-top (the reference's
    RunBottomUpBuild(hybrid=true), src/BuildWrapper.cu:350-361). The root
    is a single node appended after the LBVH slots, with count 1."""
    base, pairs = lbvh.build_lbvh(triangles, enable_pairs=enable_pairs)
    sub_idx, sub_min, sub_max, sub_count = extract_depth(base)
    dev = triangles.device
    num_base = base.num_slots
    # the top's nodes, and the arena's trash row past them
    extra = 2 * MAX_SUBROOTS + 2
    pad = extra + 1

    def grow(x, fill):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])

    arena = Arena(
        node_min=grow(base.node_min, _EMPTY), node_max=grow(base.node_max, -_EMPTY),
        child=grow(base.child, 0), count=grow(base.count, 0), type=grow(base.type, 0),
        parent=torch.cat([base.parent,
                          num_base + torch.arange(pad, dtype=torch.int32, device=dev)]),
        wptr=torch.tensor(num_base + 1, dtype=torch.int64, device=dev))

    # each sub-root pair is a Box leaf pointing at the pair (leaf type
    # ChildType_Box, primitive count 2: src/BuildWrapper.cu:356-360)
    leaves = LeafInput(
        aabb_min=sub_min, aabb_max=sub_max, child=sub_idx.clamp(min=0),
        count=torch.full((MAX_SUBROOTS,), 2, dtype=torch.int32, device=dev),
        type=torch.full((MAX_SUBROOTS,), CHILD_BOX, dtype=torch.int32, device=dev),
        num_leaves=sub_count)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    root_slot = torch.full((1,), num_base, dtype=torch.int32, device=dev)
    frontier_build(leaves, arena, zero, sub_count.reshape(1).to(torch.int32), root_slot, 1)
    n = arena.num_slots
    return BVH(node_min=arena.node_min[:n], node_max=arena.node_max[:n], child=arena.child[:n],
               count=arena.count[:n], type=arena.type[:n], parent=arena.parent[:n],
               root=torch.tensor(num_base, dtype=torch.int32, device=dev),
               root_count=torch.tensor(1, dtype=torch.int32, device=dev)), pairs
