"""Bottom-up (Karras) LBVH build, and the Morton-sorted pair rows that the
split-BVH build starts from.

Port of ``tpu_raytracing/bvh/lbvh.py``: ``scene_aabb``, ``_pair_assembly``,
``fused_sorted_pairs``, ``generate_morton_codes(_pairs)``, ``sort_codes``,
``_cpl``, ``generate_hierarchy``, ``refit_ranges``, ``tree_height``,
``generate_triangles``, ``refit``, ``_leaf_slots_from_hierarchy`` and
``build_lbvh``, and ``build_lbvh_from_aabbs``, the LBVH over arbitrary leaf
boxes that ``bvh/tlas.py`` builds its TLAS with.

Morton codes are uint32 values held in int64 tensors; invalid entries get
the key ``0xFFFFFFFF`` and sort to the end. The reference's stable
``lax.sort`` becomes a stable argsort plus a gather, which puts ties in the
same slots. torch has no ``clz``: ``clz32`` is an exact 5-step binary
search. The reference's 34-step ``fori_loop``s are Python loops over dense
tensors (on the card, ``generate_hierarchy``'s are one kernel,
``csrc/lbvh_hierarchy.cu``), and its ``.at[...].set(mode="drop")``
scatters index only the in-range entries. Every output is bit-equal to
the reference's.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.pairing import can_form_pair, create_pairs, should_form_pair
from tpu_raytracing_torch.bvh.types import (
    BVH,
    CHILD_BOX,
    CHILD_NONE,
    CHILD_TRI,
    TrianglePairs,
    empty_bvh,
)
from tpu_raytracing_torch.ops import _cuda_build
from tpu_raytracing_torch.ops.intersect import triangle_aabb
from tpu_raytracing_torch.ops.morton import morton3d
from tpu_raytracing_torch.trace.traverse import pack_pairs
from tpu_raytracing_torch.utils import timing

_INVALID_CODE = 0xFFFFFFFF
_U32 = 0xFFFFFFFF
_F32_MAX = float(torch.finfo(torch.float32).max)
# Longest possible common prefix: 30 Morton bits + 32 index tie-break bits,
# so Karras tree depth is bounded by ~64 regardless of input size.
MAX_TREE_DEPTH = 64
# XLA evaluates ``jnp.mean`` over 3 vertices as sum * float32(1/3); the
# port uses the same constant so centroids, and hence codes, match bit
# for bit.
_THIRD = 1.0 / 3.0
# launches of the hierarchy kernel in this process: generate_hierarchy adds
# one where it launches it and nowhere else
launch_count = 0


def scene_aabb(triangles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scene bounds over all vertices (src/Multiblock.cu:104-114)."""
    pts = triangles.reshape(-1, 3)
    return pts.amin(dim=0), pts.amax(dim=0)


def _centre(tri: torch.Tensor) -> torch.Tensor:
    return (tri[:, 0] + tri[:, 1] + tri[:, 2]) * _THIRD


def _pair_assembly(triangles, aabb_min, aabb_max, enable_pairs: bool):
    """Pairing tests + packed rows + Morton keys/values, before the sort.

    Returns (codes [n] int64, values [n] int64 holding uint32 bits with the
    MSB pair flag, rows [n, 16] int32).
    """
    num = triangles.shape[0]
    dev = triangles.device
    extent = aabb_max - aabb_min

    def code_of(c):
        return morton3d(((c - aabb_min) / extent).clamp(0.0, 1.0))

    if not enable_pairs:
        idx = torch.arange(num, dtype=torch.int32, device=dev)
        codes = code_of(_centre(triangles))
        values = idx.to(torch.int64)
        rows = pack_pairs(create_pairs(
            triangles, triangles, idx, idx,
            torch.zeros((num,), dtype=torch.bool, device=dev))).rows
        return codes, values, rows

    num_even = (num + 1) // 2
    a = triangles[0::2]
    has_b = torch.arange(num_even, device=dev) * 2 + 1 < num
    tri_even = torch.cat([triangles, triangles[-1:]], dim=0) if num % 2 else triangles
    b = tri_even[1::2]
    a_min, a_max = triangle_aabb(a[:, 0], a[:, 1], a[:, 2])
    b_min, b_max = triangle_aabb(b[:, 0], b[:, 1], b[:, 2])
    c_min = torch.minimum(a_min, b_min)
    c_max = torch.maximum(a_max, b_max)
    can, _, _ = can_form_pair(a, b)
    merge = has_b & can & should_form_pair(a_min, a_max, b_min, b_max, c_min, c_max)
    centre_a = _centre(a)
    centre_b = _centre(b)
    centre_first = torch.where(merge[:, None], (centre_a + centre_b) * 0.5, centre_a)
    tid = torch.arange(num_even, dtype=torch.int64, device=dev) * 2
    codes_a = code_of(centre_first)
    val_a = torch.where(merge, tid | 0x80000000, tid)
    second_valid = has_b & ~merge
    codes_b = torch.where(second_valid, code_of(centre_b), _INVALID_CODE)
    val_b = tid + 1
    idx_a = tid.to(torch.int32)
    idx_b = torch.clamp(idx_a + 1, max=num - 1)
    rows_a = pack_pairs(create_pairs(a, b, idx_a, idx_b, merge)).rows
    # B entries are always unpaired: create_pairs ignores its b operand.
    rows_b = pack_pairs(create_pairs(
        b, b, idx_b, idx_b,
        torch.zeros((num_even,), dtype=torch.bool, device=dev))).rows
    codes = torch.stack([codes_a, codes_b], dim=1).reshape(-1)[:num]
    values = torch.stack([val_a, val_b], dim=1).reshape(-1)[:num]
    rows = torch.stack([rows_a, rows_b], dim=1).reshape(-1, 16)[:num]
    return codes, values, rows


def fused_sorted_pairs(triangles, aabb_min, aabb_max, enable_pairs: bool):
    """Morton sort carrying the packed pair rows.

    Returns (sorted_codes [n] int64, sorted_rows [n, 16] int32,
    sorted_values [n] int64, num_leaves [] int64 tensor).
    """
    codes, values, rows = _pair_assembly(triangles, aabb_min, aabb_max, enable_pairs)
    perm = torch.sort(codes, stable=True).indices
    num_leaves = (codes != _INVALID_CODE).sum()
    return codes[perm], rows[perm], values[perm], num_leaves


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the low 32 bits of an integer tensor (32 for 0), as
    int64: an exact binary search over 16, 8, 4, 2 and 1 bits."""
    x = x.to(torch.int64) & _U32
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_zero = (x >> (32 - s)) == 0
        n = n + torch.where(top_zero, s, 0)
        x = torch.where(top_zero, (x << s) & _U32, x)
    return n + (x == 0).to(torch.int64)


def generate_morton_codes(triangles, aabb_min, aabb_max):
    """Codes + identity values, one per triangle (src/BottomUpBuilder.cu:98-115).
    Returns (codes [n] int64, values [n] int64), uint32 values."""
    norm = ((_centre(triangles) - aabb_min) / (aabb_max - aabb_min)).clamp(0.0, 1.0)
    codes = morton3d(norm)
    values = torch.arange(triangles.shape[0], dtype=torch.int64, device=triangles.device)
    return codes, values


def generate_morton_codes_pairs(triangles, aabb_min, aabb_max):
    """Paired Morton codes (src/BottomUpBuilder.cu:117-164).

    Adjacent triangles (2t, 2t+1) merge into one leaf when they share an
    edge and pass the surface-area heuristic; a merged leaf's value carries
    the MSB pair flag. Leaves are compacted into a dense prefix by a prefix
    sum. Returns (codes, values, num_leaves) padded to T with 0xFFFFFFFF
    keys that sort to the end; ``num_leaves`` is a 0-d int64 tensor.
    """
    num = triangles.shape[0]
    dev = triangles.device
    num_even = (num + 1) // 2
    a = triangles[0::2]
    has_b = torch.arange(num_even, device=dev) * 2 + 1 < num
    tri_even = torch.cat([triangles, triangles[-1:]], dim=0) if num % 2 else triangles
    b = tri_even[1::2]
    a_min, a_max = triangle_aabb(a[:, 0], a[:, 1], a[:, 2])
    b_min, b_max = triangle_aabb(b[:, 0], b[:, 1], b[:, 2])
    c_min = torch.minimum(a_min, b_min)
    c_max = torch.maximum(a_max, b_max)
    can, _, _ = can_form_pair(a, b)
    merge = has_b & can & should_form_pair(a_min, a_max, b_min, b_max, c_min, c_max)
    centre_a = _centre(a)
    centre_b = _centre(b)
    centre_first = torch.where(merge[:, None], (centre_a + centre_b) * 0.5, centre_a)
    extent = aabb_max - aabb_min

    def code_of(c):
        return morton3d(((c - aabb_min) / extent).clamp(0.0, 1.0))

    tid = torch.arange(num_even, dtype=torch.int64, device=dev) * 2
    first_codes = code_of(centre_first)
    first_values = torch.where(merge, tid | 0x80000000, tid)
    second_valid = has_b & ~merge
    second_codes = code_of(centre_b)
    second_values = tid + 1

    counts = 1 + second_valid.to(torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    num_leaves = (starts[-1] + counts[-1]) if num_even else torch.zeros((), dtype=torch.int64)
    codes = torch.full((num,), _INVALID_CODE, dtype=torch.int64, device=dev)
    values = torch.zeros((num,), dtype=torch.int64, device=dev)
    codes[starts] = first_codes
    values[starts] = first_values
    codes[starts[second_valid] + 1] = second_codes[second_valid]
    values[starts[second_valid] + 1] = second_values[second_valid]
    return codes, values, num_leaves


def sort_codes(codes, values):
    """Stable key/value sort (replaces src/RadixSort.cu:171-225)."""
    sorted_codes, perm = torch.sort(codes, stable=True)
    return sorted_codes, values[perm]


def _cpl(codes, i, j, count):
    """Common-prefix length with index tie-break (src/BottomUpBuilder.cu:34-38);
    -1 when j is out of range (the standard Karras boundary convention)."""
    valid = (j >= 0) & (j < count)
    j_safe = j.clamp(0, codes.shape[0] - 1)
    xor_codes = codes[i] ^ codes[j_safe]
    xor_idx = (i ^ j_safe) & _U32
    out = torch.where(xor_codes == 0, 32 + clz32(xor_idx), clz32(xor_codes))
    return torch.where(valid, out, -1)


def generate_hierarchy(sorted_codes, count):
    """Karras internal-node construction (src/BottomUpBuilder.cu:167-215).

    ``count`` (the live leaf count) is an int or a 0-d tensor; arrays are
    padded to ``sorted_codes``' length. Returns (BVH, range_lo, range_hi):
    topology plus each slot's covered sorted-leaf range; boxes are filled by
    ``refit_ranges``. CPU tensors run ``generate_hierarchy_plain``; on the
    card two or more codes take the hierarchy kernel
    (``csrc/lbvh_hierarchy.cu``), one launch and bit-equal.
    """
    global launch_count
    dev = sorted_codes.device
    n_max = sorted_codes.shape[0]
    if dev.type != "cuda" or n_max < 2:
        return generate_hierarchy_plain(sorted_codes, count)
    fn = _cuda_build.load_library("lbvh_hierarchy").lbvh_hierarchy_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    codes = sorted_codes.to(torch.int64).contiguous()
    count_dev = torch.as_tensor(count, dtype=torch.int64, device=dev).reshape(1)
    num_slots = 2 * (n_max - 1)
    child, ntype, count_field = (torch.empty((num_slots,), dtype=torch.int32, device=dev)
                                 for _ in range(3))
    range_lo, range_hi = (torch.empty((num_slots,), dtype=torch.int64, device=dev)
                          for _ in range(2))
    parent = torch.arange(num_slots, dtype=torch.int32, device=dev)
    err = fn(codes.data_ptr(), count_dev.data_ptr(), child.data_ptr(), ntype.data_ptr(),
             count_field.data_ptr(), range_lo.data_ptr(), range_hi.data_ptr(),
             parent.data_ptr(), n_max, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lbvh_hierarchy kernel launch failed: cudaError {err}")
    launch_count += 1
    return _hierarchy_bvh(child, count_field, ntype, parent, dev), range_lo, range_hi


def _hierarchy_bvh(child, count_field, ntype, parent, dev) -> BVH:
    """The hierarchy's BVH: int32 topology, boxes zero until a refit."""
    num_slots = child.shape[0]
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return BVH(
        node_min=torch.zeros((num_slots, 3), dtype=torch.float32, device=dev),
        node_max=torch.zeros((num_slots, 3), dtype=torch.float32, device=dev),
        child=i32(child), count=i32(count_field), type=i32(ntype), parent=i32(parent),
        root=torch.tensor(0, dtype=torch.int32, device=dev),
        root_count=torch.tensor(2, dtype=torch.int32, device=dev),
    )


def generate_hierarchy_plain(sorted_codes, count):
    """``generate_hierarchy`` vectorised over the internal nodes in PyTorch
    operations: the CPU's path, and the reference the kernel is checked
    against on the card."""
    dev = sorted_codes.device
    n_max = sorted_codes.shape[0]
    num_slots = max(2 * (n_max - 1), 2)
    ii = torch.arange(max(n_max - 1, 0), dtype=torch.int64, device=dev)
    valid = ii < count - 1

    # DetermineRange (src/BottomUpBuilder.cu:42-68)
    d = torch.where(_cpl(sorted_codes, ii, ii + 1, count)
                    - _cpl(sorted_codes, ii, ii - 1, count) >= 0, 1, -1)
    cpl_min = _cpl(sorted_codes, ii, ii - d, count)
    lmax = torch.full_like(ii, 2)
    done = torch.zeros_like(ii, dtype=torch.bool)
    for _ in range(34):
        probe = _cpl(sorted_codes, ii, ii + lmax * d, count)
        done = done | ~(probe > cpl_min)
        lmax = torch.where(done, lmax, lmax * 2)
    length = torch.zeros_like(ii)
    for k in range(34):
        t = lmax >> (k + 1)
        probe = _cpl(sorted_codes, ii, ii + (length + t) * d, count)
        length = torch.where((t > 0) & (probe > cpl_min), length + t, length)
    j = ii + length * d
    first = torch.where(ii == 0, 0, torch.minimum(ii, j))
    last = torch.where(ii == 0, torch.as_tensor(count - 1, device=dev).to(torch.int64),
                       torch.maximum(ii, j))

    # FindSplit (src/BottomUpBuilder.cu:70-96)
    common_prefix = _cpl(sorted_codes, first, last, count)
    split = first.clone()
    step = last - first
    done = torch.zeros_like(ii, dtype=torch.bool)
    for _ in range(34):
        step = torch.where(done, step, (step + 1) >> 1)
        new_split = split + step
        probe = _cpl(sorted_codes, first, new_split, count)
        accept = ~done & (new_split < last) & (probe > common_prefix)
        split = torch.where(accept, new_split, split)
        done = done | (step <= 1)

    # child/type/parent writes (src/BottomUpBuilder.cu:186-214): slot pair
    # (2i, 2i+1) belongs to internal node i
    leaf_a = split == first
    leaf_b = split + 1 == last
    child_a = torch.where(leaf_a, split, split * 2)
    child_b = torch.where(leaf_b, split + 1, (split + 1) * 2)
    type_a = torch.where(~valid, CHILD_NONE, torch.where(leaf_a, CHILD_TRI, CHILD_BOX))
    type_b = torch.where(~valid, CHILD_NONE, torch.where(leaf_b, CHILD_TRI, CHILD_BOX))

    def interleave(x, y):
        return torch.stack([x, y], dim=1).reshape(-1)

    child = interleave(torch.where(valid, child_a, 0), torch.where(valid, child_b, 0))
    ntype = interleave(type_a, type_b)
    # sorted-leaf range covered by each slot: [first, split] on the left,
    # [split+1, last] on the right
    range_lo = interleave(first, split + 1)
    range_hi = interleave(split, last)

    parent = torch.arange(num_slots, dtype=torch.int64, device=dev)
    for src, box, pslot in ((child_a, valid & ~leaf_a, 2 * ii), (child_b, valid & ~leaf_b,
                                                                  2 * ii + 1)):
        for off in (0, 1):
            dest = src[box] + off
            keep = dest < num_slots
            parent[dest[keep]] = pslot[box][keep]

    count_field = torch.where(ntype == CHILD_BOX, 2, torch.where(ntype == CHILD_TRI, 1, 0))
    pad = num_slots - child.shape[0]
    if pad:  # n_max < 2
        z = torch.zeros((pad,), dtype=torch.int64, device=dev)
        child, ntype, count_field, range_lo, range_hi = (
            torch.cat([x.to(torch.int64), z]) for x in (child, ntype, count_field, range_lo,
                                                        range_hi))
    return _hierarchy_bvh(child, count_field, ntype, parent, dev), range_lo, range_hi


def refit_ranges(bvh: BVH, range_lo, range_hi, leaf_lo, leaf_hi) -> BVH:
    """Bottom-up refit: every slot's box is the min/max of the sorted leaf
    boxes over its covered range [range_lo, range_hi], by a sparse-table
    range minimum (log2(n) shifted-min passes). Float min/max is
    associative, so this equals the child-union fold bit for bit."""
    n = leaf_lo.shape[0]
    dev = leaf_lo.device
    levels = max(int(n - 1).bit_length(), 1)
    table = torch.cat([leaf_lo, -leaf_hi], dim=1).T.contiguous()  # [6, n] min-space
    length = torch.clamp(range_hi - range_lo + 1, min=1)
    klev = 31 - clz32(length)
    out = torch.full((6, bvh.num_slots), _F32_MAX, dtype=torch.float32, device=dev)
    for k in range(levels + 1):
        span = 1 << k
        a = table[:, range_lo.clamp(0, n - 1)]
        b = table[:, (range_hi + 1 - span).clamp(0, n - 1)]
        out = torch.where((klev == k)[None, :], torch.minimum(a, b), out)
        if k < levels:
            shifted = torch.cat([table[:, span:], torch.full((6, min(span, n)), _F32_MAX,
                                                             dtype=torch.float32,
                                                             device=dev)], dim=1)[:, :n]
            table = torch.minimum(table, shifted)
    return dataclasses.replace(bvh, node_min=out[0:3].T.contiguous(),
                               node_max=(-out[3:6]).T.contiguous())


def tree_height(bvh: BVH) -> torch.Tensor:
    """Max slot depth by pointer doubling on parent links; 7 doublings
    saturate the depth bound of MAX_TREE_DEPTH."""
    ptr = bvh.parent.to(torch.int64)
    depth = (ptr != torch.arange(bvh.num_slots, device=ptr.device)).to(torch.int64)
    for _ in range(7):
        depth = depth + depth[ptr]
        ptr = ptr[ptr]
    return depth.max()


def generate_triangles(sorted_values, triangles) -> TrianglePairs:
    """TrianglePairs in sorted-leaf order (src/BottomUpBuilder.cu:287-312);
    an unpaired leaf's primitive ids are its source index."""
    is_pair = (sorted_values >> 31).to(torch.bool)
    index = sorted_values & 0x7FFFFFFF
    second = torch.clamp(index + 1, max=triangles.shape[0] - 1)
    return create_pairs(triangles[index], triangles[second], index, second, is_pair)


def refit(bvh: BVH, lo, hi, leaf_slots, num_leaves) -> BVH:
    """Level-synchronous bottom-up refit (replaces src/BottomUpBuilder.cu:
    247-285's atomic one-visit locks): leaf k's box goes to slot
    ``leaf_slots[k]``, then ``tree_height`` passes recompute every Box slot
    from its two children."""
    k = torch.arange(leaf_slots.shape[0], device=lo.device)
    live = k < num_leaves
    slots = leaf_slots[live].to(torch.int64)
    node_min = bvh.node_min.clone()
    node_max = bvh.node_max.clone()
    node_min[slots] = lo[live]
    node_max[slots] = hi[live]
    is_box = (bvh.type == CHILD_BOX)[:, None]
    child = bvh.child.to(torch.int64).clamp(0, bvh.num_slots - 2)
    for _ in range(int(tree_height(bvh))):
        cmin = torch.minimum(node_min[child], node_min[child + 1])
        cmax = torch.maximum(node_max[child], node_max[child + 1])
        node_min = torch.where(is_box, cmin, node_min)
        node_max = torch.where(is_box, cmax, node_max)
    return dataclasses.replace(bvh, node_min=node_min, node_max=node_max)


def _leaf_slots_from_hierarchy(bvh: BVH, num_leaves_max: int) -> torch.Tensor:
    """leaf_slot[k], the slot of sorted leaf k, from the leaf slots' child
    fields (the leaf_indices writes of GenerateHierarchy)."""
    slots = torch.arange(bvh.num_slots, dtype=torch.int32, device=bvh.child.device)
    target = bvh.child.to(torch.int64)
    keep = (bvh.type == CHILD_TRI) & (target >= 0) & (target < num_leaves_max)
    out = torch.zeros((num_leaves_max,), dtype=torch.int32, device=bvh.child.device)
    out[target[keep]] = slots[keep]
    return out


def build_lbvh(triangles: torch.Tensor, enable_pairs: bool = False):
    """Full LBVH pipeline (the reference's RunBottomUpBuild,
    src/BuildWrapper.cu:253-362). Returns (BVH, TrianglePairs); shapes are
    padded to the triangle count and the live leaf count stays on the
    device. Its stages are the spans ``build.lbvh.morton`` (scene box,
    codes, pairing: GenerateMortonCodesPairs), ``.sort`` (RadixSort),
    ``.hierarchy`` (GenerateHierarchy) and ``.boxes`` (GenerateTriangles,
    GenerateAABBs)."""
    with timing.span("build.lbvh.morton"):
        aabb_min, aabb_max = scene_aabb(triangles)
        if enable_pairs:
            codes, values, num_leaves = generate_morton_codes_pairs(triangles, aabb_min,
                                                                    aabb_max)
        else:
            codes, values = generate_morton_codes(triangles, aabb_min, aabb_max)
            num_leaves = triangles.shape[0]
    with timing.span("build.lbvh.sort"):
        sorted_codes, sorted_values = sort_codes(codes, values)
    with timing.span("build.lbvh.hierarchy"):
        bvh, range_lo, range_hi = generate_hierarchy(sorted_codes, num_leaves)
    with timing.span("build.lbvh.boxes"):
        pairs = generate_triangles(sorted_values, triangles)
        # leaf k's box covers the pair's four vertices (v3 == v2 when unpaired)
        lo = torch.minimum(torch.minimum(pairs.v0, pairs.v1), torch.minimum(pairs.v2, pairs.v3))
        hi = torch.maximum(torch.maximum(pairs.v0, pairs.v1), torch.maximum(pairs.v2, pairs.v3))
        return refit_ranges(bvh, range_lo, range_hi, lo, hi), pairs


def build_lbvh_from_aabbs(leaf_min: torch.Tensor, leaf_max: torch.Tensor,
                          leaf_payload: torch.Tensor, leaf_type: int = CHILD_TRI,
                          leaf_count: int = 1) -> BVH:
    """LBVH over arbitrary leaf boxes ([L, 3] float32 each): Morton codes of
    the box centres over their own bounds, the stable sort, the Karras
    hierarchy and the range refit. The leaf slots carry ``leaf_payload``
    ([L] int) in their child field, ``leaf_count`` and ``leaf_type`` (the
    TLAS: instance ids with ChildType_Inst, which the reference declares
    but never builds, src/Common.cuh:40). The root is the slot pair 0..1.

    One leaf has no internal node, so its tree is the root pair built
    directly: slot 0 the leaf, slot 1 NONE (an inverted box)."""
    num = leaf_min.shape[0]
    dev = leaf_min.device
    if num == 0:
        raise ValueError("build_lbvh_from_aabbs needs at least one leaf")
    if num == 1:
        bvh = empty_bvh(2, device=dev)
        bvh.node_min[0] = leaf_min[0]
        bvh.node_max[0] = leaf_max[0]
        bvh.child[0] = leaf_payload[0].to(torch.int32)
        bvh.count[0] = leaf_count
        bvh.type[0] = leaf_type
        bvh.root_count = torch.tensor(2, dtype=torch.int32, device=dev)
        return bvh
    centre = (leaf_min + leaf_max) * 0.5
    cmin = centre.amin(dim=0)
    cmax = centre.amax(dim=0)
    norm = ((centre - cmin) / torch.clamp(cmax - cmin, min=1e-30)).clamp(0.0, 1.0)
    codes = morton3d(norm)
    values = torch.arange(num, dtype=torch.int64, device=dev)
    sorted_codes, sorted_values = sort_codes(codes, values)
    bvh, range_lo, range_hi = generate_hierarchy(sorted_codes, num)
    is_leaf = bvh.type == CHILD_TRI
    payload = leaf_payload[sorted_values[bvh.child.to(torch.int64).clamp(0, num - 1)]]
    bvh = dataclasses.replace(
        bvh,
        child=torch.where(is_leaf, payload.to(torch.int32), bvh.child),
        count=torch.where(is_leaf, leaf_count, bvh.count).to(torch.int32),
        type=torch.where(is_leaf, leaf_type, bvh.type).to(torch.int32))
    return refit_ranges(bvh, range_lo, range_hi, leaf_min[sorted_values], leaf_max[sorted_values])
