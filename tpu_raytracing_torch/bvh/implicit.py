"""Implicit (complete-heap) LBVH: a build with no gathers.

Port of ``tpu_raytracing/bvh/implicit.py`` (``build_implicit``,
``build_implicit_wide_fat``). Leaves are the Morton-sorted triangles; the
topology is a complete binary heap over the next power of two (node i's
children are slots 2i and 2i + 1), and the boxes come bottom up from
pairwise min/max reductions. Level l of the heap occupies slots
[2^l, 2^(l+1)); slot 0 is unused and the root group is (1, 1). Padding
leaves (n .. 2^L) carry inverted (+-F32_MAX) boxes and are never hit.

The tree is a median split of the Morton order, not Karras's
highest-differing-bit split, so on uneven scenes it is a worse tree
(``bench.py:94-97``); it is the cheapest per-frame rebuild.
"""

from __future__ import annotations

import torch

from tpu_raytracing_torch.bvh import lbvh
from tpu_raytracing_torch.bvh.types import BVH, CHILD_BOX, CHILD_NONE, CHILD_TRI, TrianglePairs
from tpu_raytracing_torch.bvh.wide import WIDE, FatWideBVH
from tpu_raytracing_torch.trace.traverse import f2i, pack_pairs

_F32_MAX = float(torch.finfo(torch.float32).max)


def _depth(num: int) -> int:
    return max((num - 1).bit_length(), 1)


def build_implicit(triangles: torch.Tensor):
    """Morton sort + complete-heap box reduction: (BVH, TrianglePairs)."""
    num = triangles.shape[0]
    dev = triangles.device
    aabb_min, aabb_max = lbvh.scene_aabb(triangles)
    codes, values = lbvh.generate_morton_codes(triangles, aabb_min, aabb_max)
    _, sorted_values = lbvh.sort_codes(codes, values)
    pairs: TrianglePairs = lbvh.generate_triangles(sorted_values, triangles)

    depth = _depth(num)
    cap = 1 << depth
    pad = torch.full((cap - num, 3), _F32_MAX, dtype=torch.float32, device=dev)
    lo = torch.minimum(torch.minimum(pairs.v0, pairs.v1), torch.minimum(pairs.v2, pairs.v3))
    hi = torch.maximum(torch.maximum(pairs.v0, pairs.v1), torch.maximum(pairs.v2, pairs.v3))
    level_lo = [torch.cat([lo, pad])]
    level_hi = [torch.cat([hi, -pad])]
    for _ in range(depth):  # level k holds cap >> k boxes
        level_lo.append(level_lo[-1].reshape(-1, 2, 3).amin(dim=1))
        level_hi.append(level_hi[-1].reshape(-1, 2, 3).amax(dim=1))
    one = torch.full((1, 3), _F32_MAX, dtype=torch.float32, device=dev)
    node_min = torch.cat([one] + level_lo[::-1])
    node_max = torch.cat([-one] + level_hi[::-1])

    slots = torch.arange(2 * cap, dtype=torch.int32, device=dev)
    is_leaf_level = slots >= cap
    leaf_idx = slots - cap
    ntype = torch.where(is_leaf_level & (leaf_idx < num), CHILD_TRI,
                        torch.where(is_leaf_level, CHILD_NONE, CHILD_BOX)).to(torch.int32)
    ntype[0] = CHILD_NONE
    child = torch.where(is_leaf_level, leaf_idx, 2 * slots).to(torch.int32)
    count = torch.where(ntype == CHILD_BOX, 2,
                        torch.where(ntype == CHILD_TRI, 1, 0)).to(torch.int32)
    parent = torch.clamp(slots >> 1, min=1).to(torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    bvh = BVH(node_min=node_min, node_max=node_max, child=child, count=count, type=ntype,
              parent=parent, root=torch.tensor(1, **i32), root_count=torch.tensor(1, **i32))
    return bvh, pairs


def build_implicit_wide_fat(triangles: torch.Tensor):
    """The implicit build collapsed straight to fat wide rows: a wide node
    at heap level l has its 8 descendants at level l + 3 in one contiguous
    slot range, so the collapse is slicing and reshaping. Wide ids are
    level-major: wide level k holds heap level 3k, from id (8^k - 1) / 7.
    Returns (FatWideBVH, TrianglePairs, BVH)."""
    bvh, pairs = build_implicit(triangles)
    num = triangles.shape[0]
    dev = triangles.device
    depth = _depth(num)
    cap = 1 << depth
    pair_rows = pack_pairs(pairs).rows
    pad_pairs = torch.cat([pair_rows, torch.zeros((cap - num, 16), dtype=torch.int32,
                                                  device=dev)])
    rows_per_level = []
    k = 0
    while 3 * k < depth:
        lvl = 3 * k
        step = min(3, depth - lvl)
        n_nodes, n_child = 1 << lvl, 1 << step
        c_start = 1 << (lvl + step)
        c_slots = torch.arange(c_start, 2 * c_start, dtype=torch.int64, device=dev)
        cmin = bvh.node_min[c_start:2 * c_start]
        cmax = bvh.node_max[c_start:2 * c_start]
        if lvl + step == depth:  # the children are the leaves: pair order is leaf order
            leaf_idx = c_slots - cap
            live = leaf_idx < num
            etype = torch.where(live, CHILD_TRI, CHILD_NONE)
            echild = leaf_idx
            ecount = live.to(torch.int64)
            epair = pad_pairs
        else:
            etype = torch.full((c_start,), CHILD_BOX, dtype=torch.int64, device=dev)
            echild = (8 ** (k + 1) - 1) // 7 + (c_slots - c_start)
            ecount = torch.full_like(echild, 2)
            epair = torch.zeros((c_start, 16), dtype=torch.int32, device=dev)
        meta = ((echild << 5) | (ecount.clamp(0, 7) << 2) | etype.clamp(0, 3)).to(torch.int32)
        entry = torch.cat([f2i(cmin), f2i(cmax), meta[:, None],
                           torch.zeros((c_start, 1), dtype=torch.int32, device=dev)], dim=1)
        node_words = entry.reshape(n_nodes, n_child, 8)
        pair_words = epair.reshape(n_nodes, n_child, 16)
        if n_child < WIDE:
            node_words = torch.cat([node_words, node_words.new_zeros(
                (n_nodes, WIDE - n_child, 8))], dim=1)
            pair_words = torch.cat([pair_words, pair_words.new_zeros(
                (n_nodes, WIDE - n_child, 16))], dim=1)
        rows_per_level.append(torch.cat([node_words.reshape(n_nodes, 64),
                                         pair_words.reshape(n_nodes, 128)], dim=1))
        k += 1
    rows = torch.cat(rows_per_level)
    fat = FatWideBVH(rows=rows, num_nodes=torch.tensor(rows.shape[0], dtype=torch.int64,
                                                        device=dev), live_rows=rows.shape[0])
    return fat, pairs, bvh
