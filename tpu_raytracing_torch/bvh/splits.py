"""Bounded spatial splits (reference: SetupSplits / SetupPairSplits,
src/Multiblock.cu:200-425).

Port of ``tpu_raytracing/bvh/splits.py`` (``_grid_cell``, ``_cell_bounds``,
``_clip_tri_box_aabb``, ``setup_split_leaves``), bit-equal to it.
Primitives whose AABB spans several cells of a 4x4x4 grid over the scene
AABB become one clipped reference per overlapped cell, under a budget of
num_triangles/5 extra references granted by descending unsplit surface
area (a stable sort, then a prefix sum); each reference's box is then
tightened to (triangle ∩ box). Cells are enumerated in a fixed 64-step
loop over grid offsets, x fastest (GridNextCell, src/Multiblock.cu:118-131),
twice: once to count each primitive's references, once to store them.

Each float operation keeps the reference's order, and where XLA's CPU
compiler fuses a multiply into the add or subtract that consumes it, the
port rounds once too (``_fma``; sums over 3 axes are fma chains from 0.0,
``_dot3``), so boxes are bit-equal. Masked stores go to a trash row, as in
``bvh/sah.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.pairing import can_form_pair, create_pairs, should_form_pair
from tpu_raytracing_torch.bvh.sah import BLOCK_GRID_DIM, LeafInput, _bin_index, _drop_store, _fma
from tpu_raytracing_torch.bvh.types import CHILD_TRI, TrianglePairs
from tpu_raytracing_torch.ops.intersect import triangle_aabb
from tpu_raytracing_torch.ops.rangemin import from_key, ordered_key


def _dot3(a, b):
    """``jnp.sum(a * b, axis=-1)`` over 3 components, as a chain of fused
    multiply-adds from 0.0."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], _fma(a[..., 0], b[..., 0],
                                                                      torch.zeros_like(a[..., 0]))))


def _cross(a, b):
    """``jnp.cross(a, b)`` with each ``x * y - z * w`` fused as fma(x, y, -(z * w))."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([_fma(ay, bz, -(az * by)), _fma(az, bx, -(ax * bz)),
                        _fma(ax, by, -(ay * bx))], dim=-1)


def _grid_cell(p, gmin, gmax):
    """CalculateGridcell (src/Multiblock.cu:84-89)."""
    return _bin_index(torch.floor((p - gmin) * BLOCK_GRID_DIM / (gmax - gmin)),
                      BLOCK_GRID_DIM - 1)


def _cell_bounds(cell, gmin, gmax):
    """CellToBounds (src/Multiblock.cu:91-100)."""
    step = (gmax - gmin) / BLOCK_GRID_DIM
    return (_fma(cell.to(torch.float32), step, gmin),
            _fma((cell + 1).to(torch.float32), step, gmin))


def _tiny_safe(x):
    """|x| < 1e-30 -> +-1e-30 (the sign of x; +0 and -0 alike -> +1e-30)."""
    return torch.where(x.abs() < 1e-30, torch.where(x < 0, -1e-30, 1e-30), x)


def _clip_tri_box_aabb(v0, v1, v2, bmin, bmax):
    """Tight AABB of (triangle ∩ box): the hull of a fixed candidate set,
    (a) triangle vertices inside the box, (b) triangle-edge x box-face
    points lying in both, (c) box-edge x triangle-plane points inside the
    triangle: 3 + 18 + 12 = 33 masked candidates per reference.

    v*: [R, 3]; bmin/bmax: [R, 3]. Returns (lo, hi, nonempty) with lo/hi
    valid only where nonempty; intersected with [bmin, bmax] and inflated
    so float rounding can only loosen the box.
    """
    eps = 1e-6
    big = 3.0e38
    verts = torch.stack([v0, v1, v2], dim=1)  # [R, 3, 3]
    cands = []  # ([R, 3] point, [R] valid)

    def inside(p):
        return ((p >= bmin - eps) & (p <= bmax + eps)).all(dim=-1)

    # (a) triangle vertices inside the box
    for i in range(3):
        p = verts[:, i]
        cands.append((p, inside(p)))

    # (b) triangle edges x box faces
    for i in range(3):
        a = verts[:, i]
        d = verts[:, (i + 1) % 3] - a
        for axis in range(3):
            da = d[:, axis]
            safe = _tiny_safe(da)
            for bound in (bmin[:, axis], bmax[:, axis]):
                t = (bound - a[:, axis]) / safe
                p = _fma(t[:, None], d, a)
                on_seg = (t >= -eps) & (t <= 1 + eps)
                cands.append((p, on_seg & inside(p) & (da.abs() > 1e-30)))

    # (c) box edges x triangle plane, point inside the triangle
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    n = _cross(e1, e2)
    d0 = _dot3(n, verts[:, 0])
    nn = _dot3(n, n)
    e3 = verts[:, 2] - verts[:, 1]
    e_len = torch.sqrt(torch.maximum(torch.maximum(_dot3(e1, e1), _dot3(e2, e2)),
                                     _dot3(e3, e3)))
    n_len = torch.sqrt(torch.clamp(nn, min=1e-30))

    def in_tri(p):
        s0 = _dot3(_cross(verts[:, 1] - verts[:, 0], p - verts[:, 0]), n)
        s1 = _dot3(_cross(verts[:, 2] - verts[:, 1], p - verts[:, 1]), n)
        s2 = _dot3(_cross(verts[:, 0] - verts[:, 2], p - verts[:, 2]), n)
        dp = p - verts[:, 0]
        pd = torch.sqrt(_dot3(dp, dp))
        tol = _fma(eps * n_len * e_len, pd + e_len, torch.full_like(pd, 1e-30))
        return (s0 >= -tol) & (s1 >= -tol) & (s2 >= -tol)

    for axis in range(3):
        u, w = (axis + 1) % 3, (axis + 2) % 3
        na = n[:, axis]
        safe = _tiny_safe(na)
        for ub in (0, 1):
            for wb in (0, 1):
                uu = (bmax if ub else bmin)[:, u]
                ww = (bmax if wb else bmin)[:, w]
                pa = _fma(-ww, n[:, w], _fma(-uu, n[:, u], d0)) / safe
                p = torch.zeros_like(v0)
                p[:, axis] = pa
                p[:, u] = uu
                p[:, w] = ww
                on_seg = (pa >= bmin[:, axis] - eps) & (pa <= bmax[:, axis] + eps)
                cands.append((p, on_seg & in_tri(p) & (na.abs() > 1e-30)))

    lo = torch.full_like(v0, big)
    hi = torch.full_like(v0, -big)
    nonempty = torch.zeros(v0.shape[:1], dtype=torch.bool, device=v0.device)
    for p, o in cands:
        lo = torch.minimum(lo, torch.where(o[:, None], p, big))
        hi = torch.maximum(hi, torch.where(o[:, None], p, -big))
        nonempty = nonempty | o
    # conservative: inflate by 4 ulps of the cell corner's magnitude, then
    # clamp into the cell box
    span = torch.clamp(hi - lo, min=0.0)
    mag = torch.maximum(bmin.abs(), bmax.abs())
    margin = _fma(torch.full_like(span, eps), span, 4.8e-7 * mag) + 1e-7
    lo = torch.maximum(lo - margin, bmin)
    hi = torch.minimum(hi + margin, bmax)
    return lo, hi, nonempty


def setup_split_leaves(triangles: torch.Tensor,
                       enable_pairs: bool) -> Tuple[LeafInput, TrianglePairs]:
    """Leaves of the split build: [num + num // 5] references (the live
    prefix ``num_leaves``) and the pairs they reference."""
    num = triangles.shape[0]
    dev = triangles.device
    threshold = max(num // 5, 1)
    cap = num + threshold

    pts = ordered_key(triangles.reshape(-1, 3))
    scene_min = from_key(pts.amin(dim=0))
    scene_max = from_key(pts.amax(dim=0))

    # ---- primitive (pair) stream ----
    if enable_pairs:
        num_even = (num + 1) // 2
        a_idx = torch.arange(num_even, dtype=torch.int64, device=dev) * 2
        has_b = a_idx + 1 < num
        b_idx = torch.clamp(a_idx + 1, max=num - 1)
        a = triangles[a_idx]
        b = triangles[b_idx]
        a_min, a_max = triangle_aabb(a[:, 0], a[:, 1], a[:, 2])
        b_min, b_max = triangle_aabb(b[:, 0], b[:, 1], b[:, 2])
        p_min = torch.minimum(a_min, b_min)
        p_max = torch.maximum(a_max, b_max)
        can, _, _ = can_form_pair(a, b)
        merge = has_b & can & should_form_pair(a_min, a_max, b_min, b_max, p_min, p_max)
        # Compact (first, maybe-second) prims: prim k <-> pair k.
        single = has_b & ~merge
        counts = 1 + single.to(torch.int64)
        starts = torch.cumsum(counts, 0) - counts
        num_prims = starts[-1] + counts[-1]
        slot2 = torch.where(single, starts + 1, num)  # num: the trash row

        def scat(v1, v2, dtype=torch.float32):
            out = torch.zeros((num + 1,) + v1.shape[1:], dtype=dtype, device=dev)
            out[starts] = v1.to(dtype)
            _drop_store(out, slot2, v2)
            return out[:num]

        prim_a_min = scat(a_min, b_min)
        prim_a_max = scat(a_max, b_max)
        prim_b_min = scat(torch.where(merge[:, None], b_min, a_min), b_min)
        prim_b_max = scat(torch.where(merge[:, None], b_max, a_max), b_max)
        prim_merge = scat(merge, torch.zeros_like(merge), torch.bool)
        src_a = scat(a_idx, b_idx, torch.int64)
        src_b = torch.where(prim_merge, torch.clamp(src_a + 1, max=num - 1), src_a)
        pairs = create_pairs(triangles[src_a], triangles[src_b], src_a, src_b, prim_merge)
        prim_live = torch.arange(num, device=dev) < num_prims
    else:
        # SetupSplits: one prim per triangle, never paired
        # (src/Multiblock.cu:229-230).
        lo, hi = triangle_aabb(triangles[:, 0], triangles[:, 1], triangles[:, 2])
        prim_a_min = prim_b_min = lo
        prim_a_max = prim_b_max = hi
        prim_merge = torch.zeros((num,), dtype=torch.bool, device=dev)
        idx = torch.arange(num, dtype=torch.int32, device=dev)
        pairs = create_pairs(triangles, triangles, idx, idx, prim_merge)
        prim_live = torch.ones((num,), dtype=torch.bool, device=dev)

    prim_min = torch.minimum(prim_a_min, prim_b_min)
    prim_max = torch.maximum(prim_a_max, prim_b_max)
    prim_count = torch.where(prim_merge, 2, 1).to(torch.int32)

    # ---- split grant under the extra-leaf budget ----
    min_cell = _grid_cell(prim_min, scene_min, scene_max)
    max_cell = _grid_cell(prim_max, scene_min, scene_max)
    spans = (min_cell != max_cell).any(dim=-1) & prim_live
    rng = max_cell - min_cell
    num_extra = torch.where(spans, (rng[:, 0] + 1) * (rng[:, 1] + 1) * (rng[:, 2] + 1) - 1, 0)
    # Priority grant: by descending unsplit surface area, so the budget
    # goes to the scene-spanning slivers first.
    ext = torch.clamp(prim_max - prim_min, min=0.0)
    sa = _fma(ext[:, 0], ext[:, 2], _fma(ext[:, 0], ext[:, 1], ext[:, 1] * ext[:, 2]))
    prio = torch.where(spans, sa, -1.0)
    order = torch.sort(-prio, stable=True).indices
    grant_sorted = (torch.cumsum(num_extra[order], 0) < threshold) & (prio[order] > 0)
    granted = torch.zeros_like(spans)
    granted[order] = grant_sorted
    granted = granted & spans

    def cell_iter(fn, state):
        """Fold over the 64 grid offsets, x-fastest (GridNextCell order)."""
        for dz in range(BLOCK_GRID_DIM):
            for dy in range(BLOCK_GRID_DIM):
                for dx in range(BLOCK_GRID_DIM):
                    off = torch.tensor([dx, dy, dz], dtype=torch.int64, device=dev)
                    cell = min_cell + off[None, :]
                    in_range = (cell <= max_cell).all(dim=-1) & granted
                    cmin, cmax = _cell_bounds(cell, scene_min, scene_max)
                    ia_min = torch.maximum(prim_a_min, cmin)
                    ia_max = torch.minimum(prim_a_max, cmax)
                    ib_min = torch.maximum(prim_b_min, cmin)
                    ib_max = torch.minimum(prim_b_max, cmax)
                    va = (ia_max >= ia_min).all(dim=-1)
                    vb = (ib_max >= ib_min).all(dim=-1)
                    # Merged pairs drop cells neither triangle AABB overlaps
                    # (src/Multiblock.cu:362-371).
                    ok = in_range & torch.where(prim_merge, va | vb, True)
                    pm = prim_merge[:, None]
                    clip_min = torch.where(pm, torch.minimum(ia_min, ib_min), ia_min)
                    clip_max = torch.where(pm, torch.maximum(ia_max, ib_max), ia_max)
                    state = fn(state, ok, clip_min, clip_max)
        return state

    counts_per_prim = cell_iter(lambda c, ok, *_: c + ok.to(torch.int64),
                                torch.zeros_like(num_extra))
    counts_per_prim = torch.where(prim_live & ~granted, 1, counts_per_prim)
    ref_start = torch.cumsum(counts_per_prim, 0) - counts_per_prim
    num_leaves = (ref_start[-1] + counts_per_prim[-1] if num
                  else torch.zeros((), dtype=torch.int64, device=dev))

    leaf_min = torch.zeros((cap + 1, 3), dtype=torch.float32, device=dev)
    leaf_max = torch.zeros((cap + 1, 3), dtype=torch.float32, device=dev)
    leaf_child = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    leaf_cnt = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    prim_ids = torch.arange(prim_min.shape[0], dtype=torch.int32, device=dev)

    def store(pos, lo, hi):
        _drop_store(leaf_min, pos, lo)
        _drop_store(leaf_max, pos, hi)
        _drop_store(leaf_child, pos, prim_ids)
        _drop_store(leaf_cnt, pos, prim_count)

    # Unsplit prims: one unclipped reference.
    store(torch.where(prim_live & ~granted, ref_start, cap), prim_min, prim_max)

    def write(cursor, ok, clip_min, clip_max):
        store(torch.where(ok, ref_start + cursor, cap), clip_min, clip_max)
        return cursor + ok.to(torch.int64)

    cell_iter(write, torch.zeros_like(num_extra))
    leaf_min, leaf_max = leaf_min[:cap], leaf_max[:cap]
    leaf_child, leaf_cnt = leaf_child[:cap], leaf_cnt[:cap]

    # ---- tight clip post-pass: each stored box is aabb ∩ cell, and
    # tri ∩ (aabb ∩ cell) == tri ∩ cell, so clipping the prim's
    # triangle(s) against the reference's own box gives the tight per-cell
    # AABB; unsplit references come back unchanged. Empty intersections
    # keep the loose box. ----
    if enable_pairs:
        tri_a, tri_b = triangles[src_a], triangles[src_b]
    else:
        tri_a = tri_b = triangles
    pidc = leaf_child.to(torch.int64).clamp(0, tri_a.shape[0] - 1)
    ta, tb = tri_a[pidc], tri_b[pidc]
    lo_a, hi_a, ok_a = _clip_tri_box_aabb(ta[:, 0], ta[:, 1], ta[:, 2], leaf_min, leaf_max)
    lo_b, hi_b, ok_b = _clip_tri_box_aabb(tb[:, 0], tb[:, 1], tb[:, 2], leaf_min, leaf_max)
    bigf = 3.0e38
    t_lo = torch.minimum(torch.where(ok_a[:, None], lo_a, bigf),
                         torch.where(ok_b[:, None], lo_b, bigf))
    t_hi = torch.maximum(torch.where(ok_a[:, None], hi_a, -bigf),
                         torch.where(ok_b[:, None], hi_b, -bigf))
    any_t = (ok_a | ok_b)[:, None]
    return (
        LeafInput(aabb_min=torch.where(any_t, t_lo, leaf_min),
                  aabb_max=torch.where(any_t, t_hi, leaf_max),
                  child=leaf_child, count=leaf_cnt,
                  type=torch.full((cap,), CHILD_TRI, dtype=torch.int32, device=dev),
                  num_leaves=num_leaves),
        pairs,
    )
