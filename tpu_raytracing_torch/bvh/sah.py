"""Binned-SAH top-down builder over a 4x4x4 scene-grid decomposition
(reference: src/SharedTaskBuilder.cu, src/Multiblock.cu, driver
src/BuildWrapper.cu:140-251).

Port of ``tpu_raytracing/bvh/sah.py``: ``LeafInput``, ``setup_leaves``,
``_select_axis``, ``_sa``, ``Arena``, ``make_arena``, ``_write_nodes``,
``_write_segments``, ``_level_step``, ``_seed_aabbs``,
``SahDeadlineExceeded``, ``frontier_build``, ``grid_partition``,
``_sah_front``, ``_sah_top_leaves`` and ``build_sah``.
Every output is bit-equal to the reference's on the same triangles.

The builder is level-synchronous: every frontier task advances together
each level; binning is one stable sort of the primitive axis keyed by
(task, bin), the SAH sweep one scatter-min of 12 channels into
(task, bin) slots with prefix and suffix mins over the 8 bins, and node
allocation prefix sums over the frontier.

The port has one form of the frontier: the host-stepped level loop, with
one host read of the task count per level, which also sizes that level's
per-task tensors to the live tasks, and the ``deadline`` check. The
reference's ``lax.while_loop`` form exists only to dodge an XLA scatter
pathology, so its switch between the two forms by scene size has no
counterpart: ``build_sah`` stands for the reference's ``build_sah_auto``.

How XLA's semantics carry over:

* ``.at[].set(mode="drop")`` becomes a store to one trash row past the
  end of the target, which is cut off afterwards: masked, never clamped.
  No two live stores share an index.
* Float mins run over ``ops/rangemin.ordered_key``s, where -0.0 sorts
  below +0.0 as in XLA (the 12-channel scatter-min, the bin scans, the
  seed range-min table, the scene bounds), so they are exact on any device.
* ``astype(int32)`` saturates in XLA (NaN -> 0): ``_bin_index`` clamps in
  float before converting, and constants are rounded to float32 before a
  tensor divides them (torch computes ``scalar / tensor`` as a reciprocal).

``debug=True`` runs the reference's in-build invariants
(``bvh/invariants.py``: CheckTask, the bin range, a plane found) as host
checks that raise; off, they cost nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from tpu_raytracing_torch.bvh.pairing import can_form_pair, create_pairs, should_form_pair
from tpu_raytracing_torch.bvh.types import BVH, CHILD_BOX, CHILD_NONE, CHILD_TRI, TrianglePairs
from tpu_raytracing_torch.ops.intersect import triangle_aabb
from tpu_raytracing_torch.ops.rangemin import (
    build_range_min,
    from_key,
    ordered_key,
    range_min_query,
)

NUM_BINS = 8
LEAF_THRESHOLD = 2
BLOCK_GRID_DIM = 4
NUM_BLOCKS = BLOCK_GRID_DIM**3
BIN_EPS = 1.1920929e-7  # 2^-23 (src/SharedTaskBuilder.cu:209)
_F32_MAX = float(torch.finfo(torch.float32).max)


@dataclasses.dataclass
class LeafInput:
    """Build leaves (the output of the reference Setup kernels,
    src/Multiblock.cu:136-198): one AABB + primitive reference per leaf."""

    aabb_min: torch.Tensor  # [L, 3] float32
    aabb_max: torch.Tensor  # [L, 3] float32
    child: torch.Tensor  # [L] int32: value written to a leaf node's child field
    count: torch.Tensor  # [L] int32: value written to a leaf node's count field
    type: torch.Tensor  # [L] int32: ChildType written to the leaf node
    num_leaves: torch.Tensor  # [] int64: live prefix (<= L)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _div(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` with ``c`` rounded to float32 first, as XLA rounds a
    weak-typed constant (torch's ``c / x`` multiplies by ``1 / x``)."""
    return torch.full_like(x, c) / x


def _bin_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """``clip(x.astype(int32), 0, hi)`` with XLA's saturating conversion
    (NaN -> 0, +inf -> max): clamp in float, then truncate."""
    return torch.nan_to_num(x, nan=0.0).clamp(0.0, float(hi)).to(torch.int64)


def _drop_store(dst: torch.Tensor, idx: torch.Tensor, vals) -> None:
    """``dst[idx] = vals`` where ``dst``'s last row is the trash row that
    masked-off stores target."""
    dst[idx] = vals if not isinstance(vals, torch.Tensor) else vals.to(dst.dtype)


def setup_leaves(triangles: torch.Tensor, enable_pairs: bool) -> Tuple[LeafInput, TrianglePairs]:
    """Per-primitive preprocessing (reference Setup, src/Multiblock.cu:136-198).

    Without pairing every triangle is its own leaf; with pairing adjacent
    triangles (2t, 2t+1) merge when they share an edge and pass the SAH
    heuristic. Leaf k references pair k; compaction is a prefix sum.
    """
    num = triangles.shape[0]
    dev = triangles.device
    if not enable_pairs:
        lo, hi = triangle_aabb(triangles[:, 0], triangles[:, 1], triangles[:, 2])
        idx = torch.arange(num, dtype=torch.int32, device=dev)
        pairs = create_pairs(triangles, triangles, idx, idx,
                             torch.zeros((num,), dtype=torch.bool, device=dev))
        return (
            LeafInput(aabb_min=lo, aabb_max=hi, child=idx,
                      count=torch.ones((num,), dtype=torch.int32, device=dev),
                      type=torch.full((num,), CHILD_TRI, dtype=torch.int32, device=dev),
                      num_leaves=torch.tensor(num, device=dev)),
            pairs,
        )

    num_even = (num + 1) // 2
    ar = torch.arange(num_even, dtype=torch.int64, device=dev)
    a = triangles[0::2]
    has_b = ar * 2 + 1 < num
    b = triangles[torch.clamp(ar * 2 + 1, max=num - 1)]
    a_min, a_max = triangle_aabb(a[:, 0], a[:, 1], a[:, 2])
    b_min, b_max = triangle_aabb(b[:, 0], b[:, 1], b[:, 2])
    p_min = torch.minimum(a_min, b_min)
    p_max = torch.maximum(a_max, b_max)
    can, _, _ = can_form_pair(a, b)
    merge = has_b & can & should_form_pair(a_min, a_max, b_min, b_max, p_min, p_max)

    single = has_b & ~merge
    counts = 1 + single.to(torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    num_leaves = starts[-1] + counts[-1]

    tid = ar * 2
    first_slot = starts
    second_slot = torch.where(single, starts + 1, num)  # num: the trash row

    lo = torch.zeros((num + 1, 3), dtype=torch.float32, device=dev)
    hi = torch.zeros((num + 1, 3), dtype=torch.float32, device=dev)
    lo[first_slot] = torch.where(merge[:, None], p_min, a_min)
    hi[first_slot] = torch.where(merge[:, None], p_max, a_max)
    _drop_store(lo, second_slot, b_min)
    _drop_store(hi, second_slot, b_max)

    leaf_count = torch.ones((num,), dtype=torch.int32, device=dev)
    leaf_count[first_slot] = _i32(torch.where(merge, 2, 1))

    # Pair k corresponds to leaf k: scatter the source triangle ids.
    src_a = torch.zeros((num + 1,), dtype=torch.int64, device=dev)
    src_a[first_slot] = tid
    _drop_store(src_a, second_slot, tid + 1)
    src_a = src_a[:num]
    is_pair = torch.zeros((num,), dtype=torch.bool, device=dev)
    is_pair[first_slot] = merge
    src_b = torch.where(is_pair, torch.clamp(src_a + 1, max=num - 1), src_a)
    pairs = create_pairs(triangles[src_a], triangles[src_b], src_a, src_b, is_pair)

    return (
        LeafInput(aabb_min=lo[:num], aabb_max=hi[:num],
                  child=torch.arange(num, dtype=torch.int32, device=dev), count=leaf_count,
                  type=torch.full((num,), CHILD_TRI, dtype=torch.int32, device=dev),
                  num_leaves=num_leaves),
        pairs,
    )


def _select_axis(cmin, cmax):
    """Longest centroid axis (src/SharedTaskBuilder.cu:197-204)."""
    length = cmax - cmin
    lx, ly, lz = length[..., 0], length[..., 1], length[..., 2]
    return (2 * ((lz > lx) & (lz > ly)).to(torch.int64)
            + ((ly > lx) & (ly >= lz)).to(torch.int64))


def _fma(a, b, c):
    """a * b + c with one rounding, as XLA's CPU compiler contracts a
    multiply into the add that consumes it: the product and the sum in
    float64, then float32 (a second rounding could differ only where the
    float64 sum ties at float32)."""
    return (a.double() * b.double() + c.double()).float()


def _sa(pmin, pmax):
    """Surface area of a box, 0 for an empty one (``aabb_surface_area``
    with XLA's contractions: 2 * fma(y, z, fma(x, y, x * z)))."""
    ext = pmax - pmin
    x, y, z = ext[..., 0], ext[..., 1], ext[..., 2]
    return torch.where((pmax >= pmin).all(dim=-1), 2.0 * _fma(y, z, _fma(x, y, x * z)), 0.0)


@dataclasses.dataclass
class Arena:
    """Node arena (the reference's nodes_out buffer plus the shared atomic
    write index, src/SharedTaskBuilder.cu:18, 548), written in place.

    Every tensor has one trash row past ``num_slots`` that masked-off
    stores go to; ``bvh()`` and the callers cut it off.

    seg_start/seg_count/depth are side tables filled by ``frontier_build``
    when present (``make_arena(track_segments=True)``): every task's leaf
    range is contiguous in the final leaf permutation and never moves once
    written, so recording (start, count, level) at node-write time gives
    each slot its final subtree window and depth."""

    node_min: torch.Tensor  # [N+1, 3] float32
    node_max: torch.Tensor  # [N+1, 3] float32
    child: torch.Tensor  # [N+1] int32
    count: torch.Tensor  # [N+1] int32
    type: torch.Tensor  # [N+1] int32
    parent: torch.Tensor  # [N+1] int32: parent slot (roots/self elsewhere)
    wptr: torch.Tensor  # [] int64: next free slot
    seg_start: Optional[torch.Tensor] = None  # [N+1] int32 final leaf-range start
    seg_count: Optional[torch.Tensor] = None  # [N+1] int32 leaf-range length
    depth: Optional[torch.Tensor] = None  # [N+1] int32 node depth (root = 0)

    @property
    def num_slots(self) -> int:
        return self.child.shape[0] - 1


def make_arena(num_slots: int, track_segments: bool = False, device=None) -> Arena:
    n = num_slots + 1

    def seg():
        return torch.zeros((n,), dtype=torch.int32, device=device) if track_segments else None

    return Arena(
        node_min=torch.full((n, 3), _F32_MAX, dtype=torch.float32, device=device),
        node_max=torch.full((n, 3), -_F32_MAX, dtype=torch.float32, device=device),
        child=torch.zeros((n,), dtype=torch.int32, device=device),
        count=torch.zeros((n,), dtype=torch.int32, device=device),
        type=torch.full((n,), CHILD_NONE, dtype=torch.int32, device=device),
        parent=torch.arange(n, dtype=torch.int32, device=device),
        wptr=torch.zeros((), dtype=torch.int64, device=device),
        seg_start=seg(), seg_count=seg(), depth=seg(),
    )


def _write_nodes(arena: Arena, slots, nmin, nmax, child, count, ntype, mask,
                 parent=None) -> None:
    idx = torch.where(mask, slots, arena.num_slots)
    _drop_store(arena.node_min, idx, nmin)
    _drop_store(arena.node_max, idx, nmax)
    _drop_store(arena.child, idx, child)
    _drop_store(arena.count, idx, count)
    _drop_store(arena.type, idx, ntype)
    if parent is not None:
        _drop_store(arena.parent, idx, parent)


def _write_segments(arena: Arena, slots, mask, start, count, depth: int) -> None:
    """Record a node's final leaf window + depth (no-op unless the arena
    tracks segments)."""
    if arena.seg_start is None:
        return
    idx = torch.where(mask, slots, arena.num_slots)
    _drop_store(arena.seg_start, idx, start)
    _drop_store(arena.seg_count, idx, count)
    _drop_store(arena.depth, idx, depth)


@dataclasses.dataclass
class _Frontier:
    """The live tasks of one level (``ntasks`` of them, on the host) and the
    leaf permutation; the reference pads these to tcap, which the live
    tasks never read past."""

    ids: torch.Tensor  # [cap] int64
    tstart: torch.Tensor  # [T] int64
    tend: torch.Tensor
    tparent: torch.Tensor
    tpmin: torch.Tensor  # [T, 3] float32
    tpmax: torch.Tensor
    tcmin: torch.Tensor
    tcmax: torch.Tensor
    ntasks: torch.Tensor  # [] int64 on the device: tasks of the next level
    level: int


def _check(ok: torch.Tensor, msg: str) -> None:
    if not bool(ok.all()):
        raise RuntimeError(msg)


def _level_step(leaves: LeafInput, s: _Frontier, arena: Arena, max_levels: int,
                debug: bool) -> _Frontier:
    """One frontier level over the ``s.tstart.shape[0]`` live tasks; writes
    the arena in place and returns the next level's tasks in 2T + 1 rows
    (the last a trash row)."""
    cap = leaves.aabb_min.shape[0]
    n = s.tstart.shape[0]
    dev = s.ids.device
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    tslot = torch.arange(n, dtype=torch.int64, device=dev)
    ids, tstart, tend, tparent = s.ids, s.tstart, s.tend, s.tparent
    tcmin, tcmax, tpmin, tpmax = s.tcmin, s.tcmax, s.tpmin, s.tpmax
    level = s.level

    counts = tend - tstart
    is_leaf1 = counts == 1
    is_leaf2 = counts == 2
    is_split = counts > LEAF_THRESHOLD
    degen = is_split & ((_sa(tcmin, tcmax) <= 0.0) | (level >= max_levels))

    if debug:
        # the reference's CheckTask (src/SharedTaskBuilder.cu:169-195)
        _check((tstart >= 0) & (tend >= tstart) & (tend <= cap),
               "SAH task range invalid (CheckTask)")
        _check((tcmin >= tpmin) & (tcmax <= tpmax) & (tcmin <= tcmax),
               "SAH task centroid bounds invalid (CheckTask)")

    def graft_parents(lid, slot, mask):
        """Box-type grafted leaves adopt their target group's slots so
        parent-pointer depth stays continuous across the graft."""
        is_graft = mask & (leaves.type[lid] == CHILD_BOX)
        for j in range(2):
            tgt = torch.where(is_graft & (j < leaves.count[lid]),
                              leaves.child[lid].to(torch.int64) + j, arena.num_slots)
            _drop_store(arena.parent, tgt, slot)

    # ---- leaf retirement (src/SharedTaskBuilder.cu:396-463) ----
    lid1 = ids[tstart.clamp(0, cap - 1)]
    _write_nodes(arena, tparent, leaves.aabb_min[lid1], leaves.aabb_max[lid1],
                 leaves.child[lid1], leaves.count[lid1], leaves.type[lid1], is_leaf1)
    graft_parents(lid1, tparent, is_leaf1)
    _write_segments(arena, tparent, is_leaf1, tstart, 1, level)
    leaf2 = is_leaf2.to(torch.int64)
    base2 = arena.wptr + 2 * (torch.cumsum(leaf2, 0) - leaf2)
    for j in range(2):
        lidj = ids[(tstart + j).clamp(0, cap - 1)]
        _write_nodes(arena, base2 + j, leaves.aabb_min[lidj], leaves.aabb_max[lidj],
                     leaves.child[lidj], leaves.count[lidj], leaves.type[lidj], is_leaf2,
                     parent=tparent)
        graft_parents(lidj, base2 + j, is_leaf2)
        _write_segments(arena, base2 + j, is_leaf2, tstart + j, 1, level + 1)
    _write_nodes(arena, tparent, tpmin, tpmax, base2, 2, CHILD_BOX, is_leaf2)
    _write_segments(arena, tparent, is_leaf2, tstart, 2, level)
    arena.wptr = arena.wptr + 2 * leaf2.sum()

    # ---- interior-node allocation (src/SharedTaskBuilder.cu:544-560) ----
    split = is_split.to(torch.int64)
    rank_s = torch.cumsum(split, 0) - split
    n_split = split.sum()
    child_idx = arena.wptr + 2 * rank_s
    _write_nodes(arena, tparent, tpmin, tpmax, child_idx, 2, CHILD_BOX, is_split)
    _write_segments(arena, tparent, is_split, tstart, counts, level)
    # Children slots record their parent for the wide collapse's depth
    # arithmetic.
    for j in range(2):
        _drop_store(arena.parent, torch.where(is_split, child_idx + j, arena.num_slots),
                    tparent)
    arena.wptr = arena.wptr + 2 * n_split

    # ---- per-primitive task/bin assignment ----
    scat = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    _drop_store(scat, torch.where(counts > 0, tstart, cap), tslot)
    task_of = torch.cummax(scat[:cap], dim=0).values
    t = task_of.clamp(0, n - 1)
    in_live = (task_of >= 0) & (pos < tend[t])
    splitting = in_live & is_split[t]

    lmin = leaves.aabb_min[ids]
    lmax = leaves.aabb_max[ids]
    centre = (lmin + lmax) * 0.5
    axis_t = _select_axis(tcmin, tcmax)
    cmin_t = tcmin.gather(1, axis_t[:, None])[:, 0][t]
    cmax_t = tcmax.gather(1, axis_t[:, None])[:, 0][t]
    c_t = centre.gather(1, axis_t[t][:, None])[:, 0]
    k1 = _div(NUM_BINS * (1.0 - BIN_EPS), cmax_t - cmin_t)
    bin_sah = _bin_index(k1 * (c_t - cmin_t), NUM_BINS - 1)
    bin_mid = ((pos - tstart[t]) >= (counts[t] >> 1)).to(torch.int64)
    bin_id = torch.where(degen[t], bin_mid, bin_sah)
    if debug:
        # bin indices in range (src/SharedTaskBuilder.cu:224-235)
        _check(~splitting | ((bin_id >= 0) & (bin_id < NUM_BINS)), "SAH bin index out of range")
    # Retired/gap/padded primitives keep their position: bin 15 sorts
    # after any live bin of the same preceding task.
    bin_id = torch.where(splitting, bin_id, 15)
    key = (task_of + 1) * 16 + bin_id
    key = torch.where(pos < leaves.num_leaves, key, (n + 2) * 16)
    ids_new = ids[torch.sort(key, stable=True).indices]

    # ---- SAH sweep via per-(task, bin) scatter reductions ----
    nb = n * NUM_BINS
    seg = torch.where(splitting, t * NUM_BINS + bin_id, nb)
    hist = torch.zeros((nb + 1,), dtype=torch.int64, device=dev)
    hist.index_add_(0, seg, torch.ones_like(seg))
    cl = torch.cumsum(hist[:nb].reshape(n, NUM_BINS), dim=1)
    packed12 = ordered_key(torch.cat([lmin, centre, -lmax, -centre], dim=1))
    binmin = torch.full((nb + 1, 12), int(ordered_key(torch.tensor(_F32_MAX))),
                        dtype=torch.int32, device=dev)
    binmin.scatter_reduce_(0, seg[:, None].expand(-1, 12), packed12, reduce="amin")
    binmin = binmin[:nb].reshape(n, NUM_BINS, 12)
    # lpre[:, b] = min over bins <= b (the left side of plane b);
    # rsuf[:, b] = min over bins >= b (right side of plane b-1). The
    # reference's associative_scan interleaves its partial results by
    # adding zero-padded copies, which turns -0.0 into +0.0: "+ 0.0" too.
    lpre = from_key(torch.cummin(binmin, dim=1).values) + 0.0
    rsuf = from_key(torch.cummin(binmin.flip(1), dim=1).values.flip(1)) + 0.0

    best_score = torch.full((n,), _F32_MAX, dtype=torch.float32, device=dev)
    best_b = torch.zeros((n,), dtype=torch.int64, device=dev)
    # Right-to-left strict improvement keeps the largest bin on ties
    # (src/SharedTaskBuilder.cu:313-327).
    for b in range(NUM_BINS - 2, -1, -1):
        clb = cl[:, b]
        left, right = lpre[:, b], rsuf[:, b + 1]
        nl = clb.to(torch.float32)
        nr = (counts - clb).to(torch.float32)
        score = _fma(_sa(left[:, 0:3], -left[:, 6:9]), nl, _sa(right[:, 0:3], -right[:, 6:9]) * nr)
        take = (clb > 0) & (clb < counts) & (score < best_score)
        best_score = torch.where(take, score, best_score)
        best_b = torch.where(take, b, best_b)
    # Degenerate tasks bin by midpoint into bins {0, 1}: the plane after
    # bin 0 IS the midpoint split.
    best_b = torch.where(degen, 0, best_b)
    best_cl = cl.gather(1, best_b[:, None])[:, 0]
    if debug:
        # plane found/valid (src/SharedTaskBuilder.cu:329-347)
        _check(~(is_split & ~degen) | ((best_cl > 0) & (best_cl < counts)),
               "no valid SAH plane for a split task")
    # Defensive: a split task with no valid plane splits at its midpoint
    # with the PARENT's boxes for both children.
    use_parent = is_split & ~degen & ((best_cl == 0) | (best_cl >= counts))
    best_cl = torch.where(use_parent, counts >> 1, best_cl)

    mid = tstart + best_cl
    left = lpre.gather(1, best_b[:, None, None].expand(-1, 1, 12))[:, 0]
    right = rsuf.gather(1, (best_b + 1)[:, None, None].expand(-1, 1, 12))[:, 0]
    up = use_parent[:, None]
    l_pmin = torch.where(up, tpmin, left[:, 0:3])
    l_cmin = torch.where(up, tcmin, left[:, 3:6])
    l_pmax = torch.where(up, tpmax, -left[:, 6:9])
    l_cmax = torch.where(up, tcmax, -left[:, 9:12])
    r_pmin = torch.where(up, tpmin, right[:, 0:3])
    r_cmin = torch.where(up, tcmin, right[:, 3:6])
    r_pmax = torch.where(up, tpmax, -right[:, 6:9])
    r_cmax = torch.where(up, tcmax, -right[:, 9:12])

    # ---- new frontier (children of splitting tasks, slot-ordered) ----
    trash = 2 * n
    lslot = torch.where(is_split, 2 * rank_s, trash)
    rslot = torch.where(is_split, 2 * rank_s + 1, trash)

    def scat2(l_vals, r_vals):
        out = torch.zeros((trash + 1,) + l_vals.shape[1:], dtype=l_vals.dtype, device=dev)
        out[lslot] = l_vals
        out[rslot] = r_vals
        return out

    return _Frontier(
        ids=ids_new, tstart=scat2(tstart, mid), tend=scat2(mid, tend),
        tparent=scat2(child_idx, child_idx + 1),
        tpmin=scat2(l_pmin, r_pmin), tpmax=scat2(l_pmax, r_pmax),
        tcmin=scat2(l_cmin, r_cmin), tcmax=scat2(l_cmax, r_cmax),
        ntasks=2 * n_split, level=level + 1)


def _seed_aabbs(leaves: LeafInput, ids, starts, ends):
    """Per-seed-task (pmax, pmin, cmax, cmin) via range-min-table queries."""
    lmin = leaves.aabb_min[ids]
    lmax = leaves.aabb_max[ids]
    centre = (lmin + lmax) * 0.5
    valid = ends > starts
    tbl = build_range_min(torch.cat([lmin, centre, -lmax, -centre], dim=1))
    q = range_min_query(tbl, torch.where(valid, starts, 0), torch.where(valid, ends - starts, 0))
    return q[:, 6:9] * -1.0, q[:, 0:3], q[:, 9:12] * -1.0, q[:, 3:6]


class SahDeadlineExceeded(RuntimeError):
    """The frontier ran past its caller's deadline; callers with a
    fallback tree catch this."""


def frontier_build(
    leaves: LeafInput,
    arena: Arena,
    seed_start: torch.Tensor,
    seed_end: torch.Tensor,
    seed_parent: torch.Tensor,
    num_seeds,
    ids0: Optional[torch.Tensor] = None,
    max_levels: Optional[int] = None,
    return_ids: bool = False,
    deadline: Optional[float] = None,
    debug: bool = False,
    stats: Optional[dict] = None,
):
    """Level-synchronous binned-SAH build over ``leaves``, written into
    ``arena`` in place; returns the arena (and, with ``return_ids``, the
    final leaf permutation, int32).

    Seeds are disjoint, start-ordered, non-empty ranges of the initial leaf
    permutation ``ids0`` (identity by default); the first ``num_seeds`` are
    live. Each level every task either retires as a leaf (count <=
    LEAF_THRESHOLD) or splits via an 8-bin SAH plane (midpoint fallback on
    degenerate centroid bounds). Past ``max_levels`` all splits switch to
    midpoint, which bounds the depth. ``deadline`` (``time.monotonic()``)
    is checked before each level; past it, ``SahDeadlineExceeded``. The
    loop is host-stepped (module docstring). A ``stats`` dict gets the
    level count (``"levels"``).
    """
    cap = leaves.aabb_min.shape[0]
    dev = leaves.aabb_min.device
    if ids0 is None:
        ids0 = torch.arange(cap, dtype=torch.int64, device=dev)
    if max_levels is None:
        max_levels = 2 * max(int(cap - 1).bit_length(), 1) + 16
    ns = int(num_seeds)
    starts = seed_start[:ns].to(torch.int64)
    ends = seed_end[:ns].to(torch.int64)
    ids0 = ids0.to(torch.int64)
    pmax0, pmin0, cmax0, cmin0 = _seed_aabbs(leaves, ids0, starts, ends)
    state = _Frontier(ids=ids0, tstart=starts, tend=ends,
                      tparent=seed_parent[:ns].to(torch.int64), tpmin=pmin0, tpmax=pmax0,
                      tcmin=cmin0, tcmax=cmax0, ntasks=torch.tensor(ns), level=0)
    while True:
        n = int(state.ntasks)  # the one host read of the level
        if n == 0:
            break
        if deadline is not None and time.monotonic() > deadline:
            raise SahDeadlineExceeded(
                f"SAH host-stepped frontier exceeded its deadline at level {state.level} "
                f"({n} tasks live)")
        state = dataclasses.replace(state, **{
            f: getattr(state, f)[:n] for f in ("tstart", "tend", "tparent", "tpmin", "tpmax",
                                               "tcmin", "tcmax")})
        state = _level_step(leaves, state, arena, max_levels, debug)
    if stats is not None:
        stats["levels"] = state.level
    if return_ids:
        return arena, state.ids.to(torch.int32)
    return arena


def grid_partition(leaves: LeafInput):
    """4x4x4 centroid-grid decomposition (src/Multiblock.cu:431-547).

    Returns (ids sorted by cell, cell_start[64], cell_end[64], counts[64]).
    Binning uses the *centroid* AABB with the same (1 - 2^-23) scale
    factor as the reference.
    """
    cap = leaves.aabb_min.shape[0]
    dev = leaves.aabb_min.device
    centre = (leaves.aabb_min + leaves.aabb_max) * 0.5
    live = (torch.arange(cap, device=dev) < leaves.num_leaves)[:, None]
    cmin = from_key(ordered_key(torch.where(live, centre, _F32_MAX)).amin(dim=0))
    cmax = from_key(ordered_key(torch.where(live, centre, -_F32_MAX)).amax(dim=0))
    scaled = (centre - cmin) * (BLOCK_GRID_DIM * (1.0 - BIN_EPS)) / (cmax - cmin)
    cell3 = _bin_index(scaled, BLOCK_GRID_DIM - 1)
    cell = cell3[:, 0] + cell3[:, 1] * BLOCK_GRID_DIM + cell3[:, 2] * BLOCK_GRID_DIM**2
    cell = torch.where(live[:, 0], cell, NUM_BLOCKS)  # pads sort last
    ids_sorted = torch.sort(cell, stable=True).indices
    counts = torch.zeros((NUM_BLOCKS + 1,), dtype=torch.int64, device=dev)
    counts.index_add_(0, cell, torch.ones_like(cell))
    counts = counts[:NUM_BLOCKS]
    scan = torch.cumsum(counts, 0)
    return _i32(ids_sorted), _i32(scan - counts), _i32(scan), _i32(counts)


def _setup(triangles, enable_pairs: bool, enable_splits: bool):
    if enable_splits:
        from tpu_raytracing_torch.bvh.splits import setup_split_leaves

        return setup_split_leaves(triangles, enable_pairs)
    return setup_leaves(triangles, enable_pairs)


def _sah_front(triangles, enable_pairs: bool, enable_splits: bool):
    """Pre-frontier stage of build_sah: setup + grid partition + seeds."""
    leaves, pairs = _setup(triangles, enable_pairs, enable_splits)
    cap = leaves.aabb_min.shape[0]
    dev = triangles.device
    ids_sorted, cell_start, cell_end, cell_counts = grid_partition(leaves)

    # Arena layout: slot 0 = overall root; slots 1..NUM_BLOCKS = cell root
    # slots (only non-empty cells used); the rest allocated by prefix sums.
    arena = make_arena(2 * cap + 2 * NUM_BLOCKS + 2, device=dev)
    arena.wptr = torch.tensor(1 + NUM_BLOCKS, device=dev)
    nonempty = cell_counts > 0
    ne = nonempty.to(torch.int64)
    num_cells = ne.sum()
    # Compact non-empty cells, keeping cell order: seed run i is the i-th
    # non-empty cell and its root lives at arena slot 1 + i.
    slot = torch.where(nonempty, torch.cumsum(ne, 0) - ne, NUM_BLOCKS)
    seed_start = torch.zeros((NUM_BLOCKS + 1,), dtype=torch.int32, device=dev)
    seed_end = torch.zeros((NUM_BLOCKS + 1,), dtype=torch.int32, device=dev)
    seed_start[slot] = cell_start
    seed_end[slot] = cell_end
    seed_parent = 1 + torch.arange(NUM_BLOCKS, dtype=torch.int32, device=dev)
    return (leaves, pairs, ids_sorted, seed_start[:NUM_BLOCKS], seed_end[:NUM_BLOCKS],
            seed_parent, num_cells, arena)


def _sah_top_leaves(arena: Arena, num_cells) -> LeafInput:
    """Top-of-tree leaf inputs over the cell roots
    (src/BuildWrapper.cu:246-250). Each non-empty cell becomes a "leaf"
    that grafts the cell root's children (src/SharedTaskBuilder.cu:424-444),
    copying the cell-root node wholesale (child, count and type): a
    single-leaf cell's root is itself a Tri leaf and stays one."""
    root_slots = 1 + torch.arange(NUM_BLOCKS, dtype=torch.int64, device=arena.child.device)
    return LeafInput(aabb_min=arena.node_min[root_slots], aabb_max=arena.node_max[root_slots],
                     child=arena.child[root_slots], count=arena.count[root_slots],
                     type=arena.type[root_slots], num_leaves=num_cells)


def build_sah(triangles: torch.Tensor, enable_pairs: bool = False,
              enable_splits: bool = False,
              debug: bool = False) -> Tuple[BVH, TrianglePairs]:
    """Full SAH pipeline (reference driver: RunSahBuild,
    src/BuildWrapper.cu:140-251): setup (pairing / spatial splits) -> grid
    decomposition -> per-cell SAH builds -> top-of-tree stitch over cell
    roots. Root is node 0 with count 1 (src/main.cu:222-223)."""
    (leaves, pairs, ids_sorted, seed_start, seed_end, seed_parent,
     num_cells, arena) = _sah_front(triangles, enable_pairs, enable_splits)
    dev = triangles.device
    frontier_build(leaves, arena, seed_start, seed_end, seed_parent, num_cells,
                   ids0=ids_sorted, debug=debug)

    # ---- top of tree over cell roots (src/BuildWrapper.cu:246-250) ----
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    frontier_build(_sah_top_leaves(arena, num_cells), arena, zero,
                   num_cells.reshape(1).to(torch.int32), zero, 1, debug=debug)
    n = arena.num_slots
    bvh = BVH(node_min=arena.node_min[:n], node_max=arena.node_max[:n],
              child=arena.child[:n], count=arena.count[:n], type=arena.type[:n],
              parent=arena.parent[:n],
              root=torch.tensor(0, dtype=torch.int32, device=dev),
              root_count=torch.tensor(1, dtype=torch.int32, device=dev))
    return bvh, pairs
