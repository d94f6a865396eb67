"""Morton-bucket BVH builds: the split tree's per-frame rebuild and refit,
and the bucket-major fat and v1 builds.

Port of ``tpu_raytracing/bvh/bucket.py``: ``SplitBVH``,
``_sorted_leaves``, ``split_front``, ``leaf_major_tables``,
``classify_split``, ``_range_min_table``, ``_range_lookup``, ``_inner_cap``,
``check_inner_capacity``, ``check_split_capacity``, ``emit_split``,
``build_bucket_split``, ``emit_split_views`` and ``refit_split`` (8- or
16-wide inner rows, ``inner_width``), the bucket-major
``_segment_totals``, ``_bucket_tables``, ``_bucket_aabbs`` and
``build_bucket_fat`` (8-wide), ``build_bucket_split_v1`` (the same tree
as ``build_bucket_split``, as the reference's docstring says),
``trace/split_pallas.py:_stack_cap`` as ``stack_cap`` and its
``prep_split_views`` as ``split_views``. Every pass is a dense tensor op
over the sorted leaves or the per-level buckets, as in the reference; the
outputs (``inner``, ``num_inner``, ``e_ranges``, ``max_slot``, the fat
rows, pair rows) are bit-equal to the reference's.

XLA primitives without a direct torch counterpart: ``lax.clz`` becomes
``torch.frexp`` on float64 (exact for every int32), reverse ``cummin`` a
flip, ``nonzero(size=, fill_value=)`` a truncate-and-pad to ``ecap``, and
``.at[].set(mode="drop")`` a masked index store.

The kernel views use the port's own layout, with none of the reference's
128-lane padding (a Mosaic DMA rule, ``split_pallas.py:120-126``):
``inner`` [ICAP, w, 8] int32 and ``pairs`` [P_pad, 16] int32 with
P_pad >= max(P, leaf_width), so no leaf window reads past the end, and the
tracer's stack bound for the tree.

``bvh/invariants.py``'s ``checkify`` checks become host checks behind
``emit_split(..., debug=True)``.

The split build's stages are spans (``utils/timing.py``) named after the
six stages of the reference's profile (``--profile-build``):
``build.morton_sort_front`` (``split_front``), ``build.bucket_tables``
(``leaf_major_tables``), ``build.classification`` (``classify_split``),
``build.range_min_aabb_table`` (the entries' range-min boxes),
``build.emit_scatter`` (``emit_split``, whose self time is the scatter)
and ``build.kernel_view_prep`` (``split_views``); the refit is
``build.refit``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from tpu_raytracing_torch.bvh.lbvh import fused_sorted_pairs, scene_aabb
from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_NONE, CHILD_TRI
from tpu_raytracing_torch.bvh.wide import WIDE, FatWideBVH
from tpu_raytracing_torch.trace.traverse import (
    _META_CHILD_SHIFT,
    _META_COUNT_SHIFT,
    _META_TYPE_MASK,
    PackedPairs,
    f2i,
    i2f,
)
from tpu_raytracing_torch.utils import timing

_F32_MAX = float(torch.finfo(torch.float32).max)
# Fine-tier depth of the range-min table (the reference's _RANGE_K0).
_RANGE_K0 = 10
# Entries per inner row the split builds emit (the reference's inner_width).
INNER_WIDTHS = (8, 16)


@dataclasses.dataclass
class SplitBVH:
    """Wide BVH split into homogeneous inner rows and leaf windows.

    ``inner``: [ICAP, w*8] int32 — w entries x (min3, max3 bit-cast f32,
    meta, pad). Meta is child << 5 | type: CHILD_BOX (child = inner row)
    or CHILD_TRI (child = start of a ``leaf_width``-pair window in the
    sorted pair array). Row 0 is the traversal root.
    """

    inner: torch.Tensor  # [ICAP, w*8] int32
    num_inner: torch.Tensor  # [] int64
    num_leaves: torch.Tensor  # [] int64 — live sorted pairs (rest zeroed)
    leaf_width: int = 16
    e_ranges: Optional[torch.Tensor] = None  # [ICAP, w, 2] int32 (start, count)
    max_slot: Optional[torch.Tensor] = None  # [] int64


def _ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x >= 1 (the reference's ``31 - clz(x)``)."""
    return torch.frexp(x.to(torch.float64))[1].to(torch.int64) - 1


def _reverse_cummin(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cummin(x.flip(dim), dim=dim).values.flip(dim)


def _sorted_leaves(triangles: torch.Tensor, enable_pairs: bool):
    """Morton sort + pair assembly + leaf AABBs.

    Returns (sorted_codes, packed, lo, hi, ccount_leaf, num_leaves)."""
    aabb_min, aabb_max = scene_aabb(triangles)
    sorted_codes, rows, sorted_values, num_leaves = fused_sorted_pairs(
        triangles, aabb_min, aabb_max, enable_pairs)
    v = i2f(rows[:, :12]).reshape(-1, 4, 3)
    ccount_leaf = (sorted_values >> 31).to(torch.int32)  # second tri valid
    return (sorted_codes, PackedPairs(rows=rows), v.amin(dim=1), v.amax(dim=1),
            ccount_leaf, num_leaves)


def _segment_totals(x, heads, tails_pos, valid, op, init: float):
    """Per-segment reduction over segments of at most ``WIDE`` elements:
    log2(WIDE) Hillis-Steele segmented inclusive scan passes, then a
    gather at each segment's tail.

    x [M, C]; heads [M] bool segment starts; tails_pos [B] last-element
    positions; valid [B] bool. Returns [B, C] (``init`` where not valid)."""
    f = heads
    m = x.shape[0]
    d = 1
    while d < WIDE:
        if d >= m:  # tiny inputs: the shift falls entirely off the array
            x_shift = torch.full_like(x, init)
            f_shift = torch.ones_like(f)
        else:
            x_shift = torch.cat([torch.full((d,) + x.shape[1:], init, dtype=x.dtype,
                                            device=x.device), x[:-d]])
            f_shift = torch.cat([torch.ones((d,), dtype=torch.bool, device=f.device), f[:-d]])
        x = torch.where(f[:, None], x, op(x_shift, x))
        f = f | f_shift
        d *= 2
    out = x[tails_pos.clamp(0, m - 1)]
    return torch.where(valid[:, None], out, init)


def _bucket_tables(sorted_codes, num_leaves, n: int):
    """Bucket-major per-level tables of the fat build, 3 Morton bits a
    level (8-wide).

    Returns (levels, caps, bids, poss, counts, child_starts, child_counts):
    level l's segment-start mask [n], its bucket capacity, each leaf's
    bucket id [n], each bucket's first leaf and leaf count [cap], and its
    children's first id and count at level l + 1 [cap]."""
    bits, width = 3, WIDE
    dev = sorted_codes.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    pad_boundary = iota == num_leaves  # the padded sentinel region starts here
    levels = [(iota == 0) | pad_boundary]
    caps = [width]
    shifts = []
    sh = 30
    while sh > 0:
        sh = max(sh - bits, 0)
        shifts.append(sh)
    for lvl, shift in enumerate(shifts, start=1):
        pref = sorted_codes >> shift
        prev = torch.cat([pref[:1] ^ 1, pref[:-1]])
        levels.append((pref != prev) | (iota == 0) | pad_boundary)
        caps.append(min(width ** lvl, n))
    # chunk levels: split runs inside the deepest Morton bucket at period
    # width^k, so every segment bottoms out at <= width leaves
    num_chunk = max(math.ceil(math.log(max(n, 2), width)), 1)
    seg_start = torch.cummax(torch.where(levels[-1], iota, -1), dim=0).values
    idx_in_seg = iota - seg_start
    prev_starts = levels[-1]
    for k in range(num_chunk - 1, -1, -1):
        prev_starts = prev_starts | (idx_in_seg % (width ** (k + 1)) == 0)
        levels.append(prev_starts)
        caps.append(n)

    bids_all = torch.cumsum(torch.stack(levels).to(torch.int64), dim=1) - 1
    bids, poss, counts = [], [], []
    for li, (starts, cap) in enumerate(zip(levels, caps)):
        bid = bids_all[li]
        pos = num_leaves.to(torch.int64).expand(cap).clone()
        keep = starts & (bid < cap)
        pos[bid[keep]] = iota[keep]
        nxt = torch.cat([pos[1:], num_leaves.to(torch.int64).reshape(1)])
        end = torch.minimum(torch.maximum(nxt, pos), num_leaves)
        counts.append(torch.clamp(end - torch.minimum(pos, num_leaves), min=0))
        bids.append(bid)
        poss.append(pos)

    # children of level-l bucket b: the contiguous level-(l+1) buckets
    # [child_start, child_start + child_count)
    child_starts, child_counts = [], []
    for lv in range(len(levels) - 1):
        pos, count, nbid = poss[lv], counts[lv], bids[lv + 1]
        cs = nbid[pos.clamp(0, n - 1)]
        last = (pos + count - 1).clamp(0, n - 1)
        child_starts.append(cs)
        child_counts.append(torch.where(count > 0, nbid[last] - cs + 1, 0))
    zeros = torch.zeros((caps[-1],), dtype=torch.int64, device=dev)
    child_starts.append(zeros)
    child_counts.append(zeros)
    return levels, caps, bids, poss, counts, child_starts, child_counts


def _bucket_aabbs(levels, caps, poss, counts, child_starts, child_counts, lo, hi, n: int):
    """Bottom-up per-level bucket boxes by segmented scans: (a_los, a_his),
    each a list of [cap, 3]."""
    num_levels = len(levels)
    a_los = [None] * num_levels
    a_his = [None] * num_levels
    tails = poss[-1] + counts[-1] - 1
    valid = counts[-1] > 0
    a_los[-1] = _segment_totals(lo, levels[-1], tails, valid, torch.minimum, _F32_MAX)
    a_his[-1] = _segment_totals(hi, levels[-1], tails, valid, torch.maximum, -_F32_MAX)
    for lv in range(num_levels - 2, -1, -1):
        # scan over level-(lv+1) buckets; parent heads mark first children
        heads = levels[lv][poss[lv + 1].clamp(0, n - 1)] | (counts[lv + 1] <= 0)
        tails = (child_starts[lv] + child_counts[lv] - 1).clamp(0, caps[lv + 1] - 1)
        valid = counts[lv] > 0
        a_los[lv] = _segment_totals(a_los[lv + 1], heads, tails, valid, torch.minimum,
                                    _F32_MAX)
        a_his[lv] = _segment_totals(a_his[lv + 1], heads, tails, valid, torch.maximum,
                                    -_F32_MAX)
    return a_los, a_his


def build_bucket_fat(triangles: torch.Tensor, enable_pairs: bool = False):
    """The fat wide BVH built straight from 3-bit Morton buckets (port of
    the reference's ``build_bucket_fat``): (FatWideBVH with its root at row
    0, PackedPairs in sorted-leaf order; a Tri entry's pair id is its
    sorted position). Rows are [n + 2, 192]; the first ``num_nodes`` are
    the tree.

    A bucket of 2..8 leaves is a terminal row listing its leaves inline; one
    of more than 8 leaves with at least 2 children branches; one with a
    single child is skipped (the effective-id recurrence); a one-leaf bucket
    is a Tri entry of its parent; buckets under a terminal are unused."""
    n = triangles.shape[0]
    dev = triangles.device
    sorted_codes, packed, lo, hi, ccount_leaf, num_leaves = _sorted_leaves(triangles, enable_pairs)
    levels, caps, bids, poss, counts, child_starts, child_counts = _bucket_tables(
        sorted_codes, num_leaves, n)
    num_levels = len(levels)

    is_small, is_real = [], []
    alive = [torch.ones((caps[0],), dtype=torch.bool, device=dev)]
    for lv in range(num_levels):
        count, cc = counts[lv], child_counts[lv]
        small = (count >= (1 if lv == 0 else 2)) & (count <= WIDE)
        branch = (count > WIDE) & (cc >= 2)
        is_small.append(small)
        is_real.append(alive[lv] & (small | branch))
        if lv < num_levels - 1:
            par = bids[lv][poss[lv + 1].clamp(0, n - 1)].clamp(0, caps[lv] - 1)
            alive.append(alive[lv][par] & ~is_small[lv][par])

    # global row ids, row 0 reserved for the root's copy
    wids = []
    offset = torch.ones((), dtype=torch.int64, device=dev)
    for lv in range(num_levels):
        r = is_real[lv].to(torch.int64)
        wids.append(offset + torch.cumsum(r, 0) - r)
        offset = offset + r.sum()
    total_rows = offset

    # effective ids: skip single-child chains, bottom-up
    effs = [None] * num_levels
    effs[-1] = wids[-1]
    for lv in range(num_levels - 2, -1, -1):
        cs = child_starts[lv].clamp(0, caps[lv + 1] - 1)
        effs[lv] = torch.where(is_real[lv], wids[lv], effs[lv + 1][cs])

    a_los, a_his = _bucket_aabbs(levels, caps, poss, counts, child_starts, child_counts,
                                 lo, hi, n)

    # stage A: compact per-row descriptors at each real bucket's row
    w_cap = n + 2
    emeta = torch.zeros((w_cap, WIDE), dtype=torch.int32, device=dev)
    nlo = torch.full((w_cap, 3), _F32_MAX, dtype=torch.float32, device=dev)
    nhi = torch.full((w_cap, 3), -_F32_MAX, dtype=torch.float32, device=dev)
    for lv in range(num_levels):
        pos, count, cap = poss[lv], counts[lv], caps[lv]
        small, real = is_small[lv], is_real[lv]
        metas = []
        for j in range(WIDE):
            leaf_p = (pos + j).clamp(0, n - 1)  # terminal: leaf j of the bucket
            t_valid = small & (j < count)
            if lv < num_levels - 1:  # branching: child bucket j at level lv + 1
                cb = (child_starts[lv] + j).clamp(0, caps[lv + 1] - 1)
                b_valid = real & ~small & (j < child_counts[lv])
                c_single = counts[lv + 1][cb] == 1
                c_leaf_p = poss[lv + 1][cb].clamp(0, n - 1)
                c_eff = effs[lv + 1][cb]
            else:
                b_valid = c_single = torch.zeros((cap,), dtype=torch.bool, device=dev)
                c_leaf_p = c_eff = torch.zeros((cap,), dtype=torch.int64, device=dev)
            is_tri = t_valid | (b_valid & c_single)
            is_box = b_valid & ~c_single
            pair_id = torch.where(t_valid, leaf_p, c_leaf_p)
            cc = torch.where(is_tri, ccount_leaf[pair_id].to(torch.int64), 0)
            child = torch.where(is_tri, pair_id, c_eff)
            etype = torch.where(is_tri, CHILD_TRI, torch.where(is_box, CHILD_BOX, CHILD_NONE))
            metas.append(torch.where(
                etype == CHILD_NONE, 0,
                (child << _META_CHILD_SHIFT) | (cc.clamp(0, 7) << _META_COUNT_SHIFT) | etype,
            ).to(torch.int32))
        keep = real & (wids[lv] < w_cap)
        dest = wids[lv][keep]
        emeta[dest] = torch.stack(metas, dim=1)[keep]
        nlo[dest] = a_los[lv][keep]
        nhi[dest] = a_his[lv][keep]

    # root: the effective root's descriptor into row 0 (the trace starts there)
    eff_root = effs[0][0].clamp(0, w_cap - 1)
    emeta[0] = emeta[eff_root].clone()
    nlo[0] = nlo[eff_root].clone()
    nhi[0] = nhi[eff_root].clone()

    # stage B: the [W, 192] fat rows in one pass
    num_pairs = packed.rows.shape[0]
    etype = (emeta & _META_TYPE_MASK)[..., None]
    eid = (emeta >> _META_CHILD_SHIFT).to(torch.int64)
    tri, box = etype == CHILD_TRI, etype == CHILD_BOX
    pid = eid.clamp(0, num_pairs - 1)
    wid_c = eid.clamp(0, w_cap - 1)
    e_lo = torch.where(tri, lo[pid], torch.where(box, nlo[wid_c], _F32_MAX))
    e_hi = torch.where(tri, hi[pid], torch.where(box, nhi[wid_c], -_F32_MAX))
    node = torch.cat([f2i(e_lo), f2i(e_hi), emeta[..., None],
                      torch.zeros((w_cap, WIDE, 1), dtype=torch.int32, device=dev)], dim=2)
    pair = torch.where(tri, packed.rows[pid], 0)
    rows = torch.cat([node.reshape(w_cap, WIDE * 8), pair.reshape(w_cap, WIDE * 16)], dim=1)
    return FatWideBVH(rows=rows, num_nodes=total_rows, live_rows=int(total_rows)), packed


@timing.spanned("build.morton_sort_front")
def split_front(triangles: torch.Tensor, enable_pairs: bool = False):
    """The build's sort-heavy front end as a standalone stage."""
    return _sorted_leaves(triangles, enable_pairs)


@timing.spanned("build.bucket_tables")
def leaf_major_tables(sorted_codes, num_leaves, n: int, width: int):
    """Leaf-major per-level bucket tables: (heads [L, n] bool, starts,
    nxts, counts — [L, n] int64), including the capped chunk ladder."""
    bits = width.bit_length() - 1
    iota = torch.arange(n, dtype=torch.int64, device=sorted_codes.device)
    pad_boundary = iota == num_leaves
    heads = [(iota == 0) | pad_boundary]
    max_ml = max(math.ceil(math.log(max(n, 2), width)) + 1, 1)
    sh = 30
    ml = 0
    while sh > 0 and ml < max_ml:
        sh = max(sh - bits, 0)
        ml += 1
        pref = sorted_codes >> sh
        prev = torch.cat([pref[:1] ^ 1, pref[:-1]])
        heads.append((pref != prev) | (iota == 0) | pad_boundary)
    num_chunk = min(max(math.ceil(math.log(max(n, 2), width)), 1), 3)
    seg_start_deep = torch.cummax(torch.where(heads[-1], iota, -1), dim=0).values
    idx_in_seg = iota - seg_start_deep
    prev_heads = heads[-1]
    for kk in range(num_chunk - 1, -1, -1):
        s = prev_heads | (idx_in_seg % (width ** (kk + 1)) == 0)
        heads.append(s)
        prev_heads = s
    heads = torch.stack(heads, dim=0)  # [L, n]
    L = heads.shape[0]

    iota_l = iota[None, :].expand(L, n)
    starts = torch.cummax(torch.where(heads, iota_l, -1), dim=1).values
    nxt_src = torch.cat(
        [torch.where(heads[:, 1:], iota_l[:, 1:], n),
         torch.full((L, 1), n, dtype=torch.int64, device=iota.device)], dim=1)
    nxts = _reverse_cummin(nxt_src, dim=1)
    counts = nxts - starts
    return heads, starts, nxts, counts


@timing.spanned("build.classification")
def classify_split(heads, starts, counts, live, num_leaves, n: int,
                   leaf_width: int):
    """Dense [L, n] classification + inner row ids + effective tags.

    Returns (alive, branch, wid_dense, num_inner, effs)."""
    L = heads.shape[0]
    dev = heads.device
    small = (counts >= 1) & (counts <= leaf_width)
    chain = torch.cat(
        [counts[:-1] == counts[1:], torch.ones((1, n), dtype=torch.bool, device=dev)], dim=0)
    branch = (counts > leaf_width) & ~chain
    alive = torch.cumprod(
        torch.cat([torch.ones((1, n), dtype=torch.bool, device=dev), ~small[:-1]], dim=0)
        .to(torch.int64), dim=0).to(torch.bool)
    real = alive & branch

    rmask = (heads & real & live[None, :]).to(torch.int64)
    rows_per_level = rmask.sum(dim=1)
    offsets = 1 + torch.cat(
        [torch.zeros((1,), dtype=torch.int64, device=dev), torch.cumsum(rows_per_level, 0)[:-1]])
    wid_dense = offsets[:, None] + torch.cumsum(rmask, dim=1) - 1
    num_inner = offsets[-1] + rows_per_level[-1]

    win_max = torch.clamp(num_leaves - leaf_width, min=0)
    win = torch.minimum(torch.minimum(starts, win_max), torch.tensor(n - 1, device=dev))
    leaf_tag = (win << 1) | 1
    inner_tag = wid_dense << 1
    eff = leaf_tag[L - 1]
    effs = [None] * L
    effs[L - 1] = eff
    for l in range(L - 2, -1, -1):
        eff = torch.where(small[l], leaf_tag[l], torch.where(branch[l], inner_tag[l], eff))
        effs[l] = eff
    return alive, branch, wid_dense, num_inner, torch.stack(effs, dim=0)


def _range_min_table(lo: torch.Tensor, hi: torch.Tensor):
    """Two-tier sparse range-min table over sorted leaf boxes.

    Packed [8, n]: rows 0-2 lo.xyz, rows 3-5 -hi.xyz, rows 6-7 +max pad.
    Returns (fine [K0, 8, n], coarse [Kc, 8, nb] or None, block size B)."""
    n = lo.shape[0]
    pad = torch.full((2, n), _F32_MAX, dtype=torch.float32, device=lo.device)
    base = torch.cat([lo.T, -hi.T, pad], dim=0)
    k_full = max(int(math.floor(math.log2(max(n, 1)))) + 1, 1)
    k0 = min(k_full, _RANGE_K0)

    def levels(cur, count, width):
        out = [cur]
        for kk in range(1, count):
            d = 1 << (kk - 1)
            if d < width:
                shifted = torch.cat(
                    [cur[:, d:], torch.full((8, d), _F32_MAX, dtype=torch.float32,
                                            device=cur.device)], dim=1)
                cur = torch.minimum(cur, shifted)
            out.append(cur)
        return torch.stack(out, dim=0)

    fine = levels(base, k0, n)
    if k_full <= _RANGE_K0:
        return fine, None, 0
    b = 1 << (k0 - 1)
    blocks = fine[k0 - 1][:, ::b].contiguous()  # [8, nb]
    nb = blocks.shape[1]
    kc = max(int(math.floor(math.log2(max(nb, 1)))) + 1, 1)
    return fine, levels(blocks, kc, nb), b


def _range_lookup(tbl, e_start: torch.Tensor, e_count: torch.Tensor):
    """AABB of sorted leaves [start, start+count) per entry, as
    (e_lo [E, 3], e_hi [E, 3]); count-0 queries are the caller's to mask."""
    fine, coarse, b = tbl
    k0, _, n = fine.shape
    ln = torch.clamp(e_count, min=1)
    klev = _ilog2(ln)
    fine_k = torch.clamp(klev, max=k0 - 1)
    pa = e_start.clamp(0, n - 1)
    pb = (e_start + ln - (1 << fine_k)).clamp(0, n - 1)
    if coarse is not None:
        kc, _, nb = coarse.shape
        pe = (e_start + ln - b).clamp(0, n - 1)
        ba = (e_start + b - 1) // b
        bb = (e_start + ln) // b
        lb = torch.clamp(bb - ba, min=1)
        kb = torch.clamp(_ilog2(lb), max=kc - 1)
        ca = ba.clamp(0, nb - 1)
        cb = (bb - (1 << kb)).clamp(0, nb - 1)
        use_fine = klev <= (k0 - 1)
    chans = []
    for r in range(6):
        v = torch.minimum(fine[fine_k, r, pa], fine[fine_k, r, pb])
        if coarse is not None:
            edge = torch.minimum(fine[k0 - 1, r, pa], fine[k0 - 1, r, pe])
            cmin = torch.minimum(coarse[kb, r, ca], coarse[kb, r, cb])
            v = torch.where(use_fine, v, torch.minimum(edge, cmin))
        chans.append(v)
    return torch.stack(chans[0:3], dim=1), -torch.stack(chans[3:6], dim=1)


def _inner_cap(n: int, leaf_width: int) -> int:
    """Static inner-row bound (branching buckets each cover > leaf_width
    leaves; 4x headroom + slack)."""
    return max(n // (2 * leaf_width) * 4, 256) + 64


def check_inner_capacity(num_inner: int, num_tris: int, leaf_width: int) -> None:
    """Raise if a host-fetched inner-row count overflowed the static bound
    (a silently truncated tree would drop geometry)."""
    cap = _inner_cap(num_tris, leaf_width)
    ni = int(num_inner)
    if ni > cap:
        raise RuntimeError(
            f"SplitBVH inner overflow: {ni} rows > static bound {cap}; "
            f"rebuild with a larger bound (bvh/bucket.py:_inner_cap)")


def check_split_capacity(split: SplitBVH, num_tris: int) -> None:
    """Host form of check_inner_capacity plus the chunk ladder's slot guard."""
    check_inner_capacity(int(split.num_inner), num_tris, split.leaf_width)
    if split.max_slot is not None:
        w = split.inner.shape[1] // 8
        ms = int(split.max_slot)
        if ms >= w:
            raise RuntimeError(
                f"SplitBVH row-slot overflow: an entry wanted slot {ms} "
                f">= width {w}; geometry was dropped — deepen the chunk "
                f"ladder (bvh/bucket.py:leaf_major_tables num_chunk)")


def _empty_entry(device) -> torch.Tensor:
    """NONE entry: inverted box so the slab test never hits."""
    box = torch.tensor([_F32_MAX] * 3 + [-_F32_MAX] * 3, dtype=torch.float32, device=device)
    return torch.cat([f2i(box), torch.zeros((2,), dtype=torch.int32, device=device)])


def _check_invariants(valid_e, e_j, wid_parent, num_inner, icap: int, width: int) -> None:
    """Host form of the reference's debug-mode build invariants
    (bvh/invariants.py): every live entry lands in a real slot of a real
    row."""
    if not bool(torch.all(~valid_e | ((e_j >= 0) & (e_j < width)))):
        raise RuntimeError("bucket entry slot out of row range")
    if not bool(torch.all(~valid_e | ((wid_parent >= 0) & (wid_parent < num_inner)))):
        raise RuntimeError("bucket entry parent row out of range")
    if int(num_inner) > icap:
        raise RuntimeError("bucket inner rows overflow the static bound")


def stack_cap(w: int, num_pair_rows: int) -> int:
    """The split tracer's stack bound for a bucket tree (port of
    ``trace/split_pallas.py:_stack_cap``): a pop pushes at most w-1 entries
    that outlive it, and depth is bounded by the build's level count (1
    root + ceil(30/bits) Morton levels + ceil(log_w n) chunk levels). It
    does not hold for an SAH tree (``split_convert.sah_stack_cap``)."""
    bits = w.bit_length() - 1
    max_levels = 2 + -(-30 // bits) + math.ceil(math.log(max(num_pair_rows, 2), w))
    return (w - 1) * max_levels + 8


def _check_widths(leaf_width: int, inner_width: int) -> None:
    if inner_width not in INNER_WIDTHS:
        raise ValueError(f"inner_width {inner_width} not in {INNER_WIDTHS}")
    # the deepest chunk buckets hold up to inner_width leaves and must fit
    # one leaf window
    if leaf_width < inner_width:
        raise ValueError(f"leaf_width {leaf_width} < inner_width {inner_width}")


@timing.spanned("build.emit_scatter")
def emit_split(front, leaf_width: int = 16, inner_width: int = 8, debug: bool = False):
    """Emit the SplitBVH from a ``split_front`` result: (SplitBVH,
    PackedPairs), with ``e_ranges`` (each entry's leaf range, what
    ``refit_split`` refreshes boxes from). Inner rows are ``inner_width``
    (8 or 16) entries wide: each level of the tree takes log2(inner_width)
    Morton bits. The pair rows past ``num_leaves`` are zeroed: leaf windows may overlap
    the padded tail, zero vertices never intersect, and a deformation that
    moves all four vertices of a row alike keeps them degenerate.
    ``debug`` runs the build invariants on the host and raises on a
    violation.
    """
    _check_widths(leaf_width, inner_width)
    width = inner_width
    sorted_codes, packed, lo, hi, _ccount, num_leaves = front
    n = sorted_codes.shape[0]
    dev = sorted_codes.device

    iota = torch.arange(n, dtype=torch.int64, device=dev)
    live = iota < num_leaves
    rows_live = torch.where(live[:, None], packed.rows, 0)

    heads, starts, nxts, counts = leaf_major_tables(sorted_codes, num_leaves, n, width)
    L = heads.shape[0]
    alive, branch, wid_dense, num_inner, effs = classify_split(
        heads, starts, counts, live, num_leaves, n, leaf_width)

    # --- compacted entry list: (level >= 1, head, parent real) ---
    emask = heads[1:] & (alive[:-1] & branch[:-1]) & live[None, :]
    icap = _inner_cap(n, leaf_width)
    ecap = min(icap * width, (L - 1) * n)
    flat = emask.reshape(-1)
    size = flat.shape[0]
    fidx = torch.nonzero(flat).reshape(-1)[:ecap]
    fidx = torch.cat([fidx, torch.full((ecap - fidx.shape[0],), size,
                                       dtype=torch.int64, device=dev)])
    valid_e = fidx < size
    fidx = torch.clamp(fidx, max=size - 1)
    gidx = fidx + n

    e_start = starts.reshape(-1)[gidx]
    e_count = counts.reshape(-1)[gidx]
    e_eff = effs.reshape(-1)[gidx]
    wid_parent = wid_dense.reshape(-1)[gidx - n]
    # Slot within the parent row: rank within the run of equal parents.
    eidx = torch.arange(ecap, dtype=torch.int64, device=dev)
    prev_wp = torch.cat([torch.full((1,), -2, dtype=torch.int64, device=dev), wid_parent[:-1]])
    run_start = torch.cummax(torch.where(wid_parent != prev_wp, eidx, -1), dim=0).values
    e_j = eidx - run_start

    with timing.span("build.range_min_aabb_table"):
        e_lo, e_hi = _range_lookup(_range_min_table(lo, hi), e_start, e_count)

    is_leaf_e = (e_eff & 1) == 1
    child = e_eff >> 1
    etype = torch.where(is_leaf_e, CHILD_TRI, CHILD_BOX)
    meta = ((child << _META_CHILD_SHIFT) | etype).to(torch.int32)
    words = torch.cat(
        [f2i(e_lo), f2i(e_hi), meta[:, None],
         torch.zeros((ecap, 1), dtype=torch.int32, device=dev)], dim=1)  # [E, 8]

    ok = valid_e & (e_j >= 0) & (e_j < width)
    max_slot = torch.where(valid_e, e_j, 0).max()
    if debug:
        _check_invariants(valid_e, e_j, wid_parent, num_inner, icap, width)
    dest = (wid_parent * width + e_j)[ok]
    inner = _empty_entry(dev).repeat(icap * width, 1)
    inner[dest] = words[ok]
    e_ranges = torch.zeros((icap * width, 2), dtype=torch.int32, device=dev)
    e_ranges[dest] = torch.stack([e_start, e_count], dim=1)[ok].to(torch.int32)
    inner = inner.reshape(icap, width * 8)
    e_ranges = e_ranges.reshape(icap, width, 2)

    # --- root: copy the effective root's row into slot 0, or synthesize a
    # single-Tri row when the whole scene is one terminal bucket ---
    root_tag = effs[0, 0]
    root_is_leaf = (root_tag & 1) == 1
    root_id = root_tag >> 1
    root_row = root_id.clamp(0, icap - 1)
    live_col = live[:, None]
    smin = torch.where(live_col, lo, _F32_MAX).amin(dim=0).clamp(max=_F32_MAX)
    smax = torch.where(live_col, hi, -_F32_MAX).amax(dim=0).clamp(min=-_F32_MAX)
    leaf_meta = ((root_id << _META_CHILD_SHIFT) | CHILD_TRI).to(torch.int32)
    leaf_row = torch.cat([
        f2i(smin), f2i(smax), leaf_meta[None],
        torch.zeros((width * 8 - 7,), dtype=torch.int32, device=dev)])
    inner[0] = torch.where(root_is_leaf, leaf_row, inner[root_row])
    leaf_rr = torch.zeros((width, 2), dtype=torch.int32, device=dev)
    leaf_rr[0, 1] = num_leaves.to(torch.int32)
    e_ranges[0] = torch.where(root_is_leaf, leaf_rr, e_ranges[root_row])

    split = SplitBVH(inner=inner, num_inner=num_inner, num_leaves=num_leaves,
                     leaf_width=leaf_width, e_ranges=e_ranges, max_slot=max_slot)
    return split, PackedPairs(rows=rows_live)


def build_bucket_split(triangles: torch.Tensor, enable_pairs: bool = False,
                       leaf_width: int = 16, inner_width: int = 8, debug: bool = False):
    """The leaf-major Morton-bucket split build: ``emit_split`` over
    ``split_front``; returns (SplitBVH, PackedPairs)."""
    return emit_split(split_front(triangles, enable_pairs), leaf_width=leaf_width,
                      inner_width=inner_width, debug=debug)


def build_bucket_split_v1(triangles: torch.Tensor, enable_pairs: bool = False,
                          leaf_width: int = 16, inner_width: int = 8):
    """The reference's round-1 bucket-major split build
    (``build_bucket_split_v1``). Its docstring says ``build_bucket_split``
    emits exactly the same SplitBVH, so here it is that build without
    ``e_ranges`` (v1 has none, so no refit): (SplitBVH, PackedPairs)."""
    split, packed = build_bucket_split(triangles, enable_pairs, leaf_width=leaf_width,
                                       inner_width=inner_width)
    return dataclasses.replace(split, e_ranges=None), packed


@timing.spanned("build.kernel_view_prep")
def split_views(split: SplitBVH, packed: PackedPairs, cap: Optional[int] = None):
    """K1's views of a split tree and its sorted pair rows (the port's
    counterpart of ``trace/split_pallas.py:prep_split_views``): (inner
    [ICAP, w, 8] i32 with w = 8 or 16, pairs [P_pad, 16] i32, stack_cap),
    sharing the tree's storage. P_pad = max(P, leaf_width): a Tri entry's window starts
    at min(start, num_leaves - leaf_width), so a scene smaller than one
    window still reads leaf_width rows. ``cap`` is the tracer's stack bound
    for the tree; by default the bucket tree's (``stack_cap``)."""
    icap, row_words = split.inner.shape
    w = row_words // 8
    if w not in INNER_WIDTHS or row_words % 8:
        raise ValueError(f"split_views: K1 takes 8- or 16-wide rows, got {row_words} words")
    rows = packed.rows
    p = rows.shape[0]
    p_pad = max(p, split.leaf_width)
    pairs = rows if p_pad == p else torch.cat(
        [rows, torch.zeros((p_pad - p, 16), dtype=torch.int32, device=rows.device)])
    if cap is None:
        cap = stack_cap(w, p_pad)
    return split.inner.reshape(icap, w, 8), pairs.contiguous(), cap


def emit_split_views(front, leaf_width: int = 16, inner_width: int = 8, debug: bool = False):
    """``emit_split`` and ``split_views`` in one call: ((inner, pairs,
    stack_cap), packed, split)."""
    split, packed = emit_split(front, leaf_width=leaf_width, inner_width=inner_width,
                               debug=debug)
    return split_views(split, packed), packed, split


@timing.spanned("build.refit")
def refit_split(split: SplitBVH, packed: PackedPairs) -> SplitBVH:
    """Topology-preserving refit: refresh every inner entry's AABB from the
    current pair rows, keeping metas, windows and row ids. The caller
    animates ``packed.rows`` in sorted-pair order (vertex words 0-11)."""
    if split.e_ranges is None:
        raise ValueError("refit_split needs e_ranges (build with emit_split)")
    icap, row_words = split.inner.shape
    w = row_words // 8
    v = i2f(packed.rows[:, :12]).reshape(-1, 4, 3)
    e_start = split.e_ranges[..., 0].reshape(-1).to(torch.int64)
    e_count = split.e_ranges[..., 1].reshape(-1).to(torch.int64)
    e_lo, e_hi = _range_lookup(_range_min_table(v.amin(dim=1), v.amax(dim=1)),
                               e_start, e_count)
    old = split.inner.reshape(icap * w, 8)
    words = torch.cat([f2i(e_lo), f2i(e_hi), old[:, 6:8]], dim=1)
    words = torch.where((e_count > 0)[:, None], words, old)
    return dataclasses.replace(split, inner=words.reshape(icap, row_words))
