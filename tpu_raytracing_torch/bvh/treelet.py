"""Treelet BVH: the per-ray treelet traversal's data structure.

Port of ``tpu_raytracing/bvh/treelet.py``: ``ECAP``, ``INNER_WIDTH``,
``TreeletCapacityError``, ``TreeletBVH``, ``table_words``, ``_head_fill``,
``_under_counts``, ``_classification``, ``treelet_capacity``,
``build_treelet``, ``build_pair_tid``, ``build_treelet_auto``,
``check_treelet_capacity`` and ``reference_walk`` (the numpy oracle the
tests use). The tables, ``pair_tid``, ``num_treelets``, ``root_tid`` and
``max_col`` are bit-equal to the reference's on the same front.

The tree is cut into treelets of at most ``ecap`` elements, each a
[WH, ecap] f32 column table. ``TreeletBVH.columns`` holds the same words
column-contiguous, [ecap, WH] per treelet: the layout the K5 kernel reads
(``tables`` is the reference's layout, which the plain version reads).
Element columns:

* INNER: 8 entries, word-major: rows [w*8 + e] for w in 0..5 hold the
  entry boxes (lo.xyz, hi.xyz), rows 48..55 the entry metas
  (child << 5 | type; 1 = BOX local col, 2 = WINDOW local col, 3 = PORTAL
  global treelet id).
* WINDOW: ``lw`` pairs word-major: rows [w*lw + p] for w in 0..11 hold
  pair p's vertex words, row 12*lw the window's start in the sorted pair
  array (int32 bits). Pairs beyond the bucket's count are zero.

Treelet roots are Morton-prefix buckets chosen in bottom-up rounds: a
round picks, top-down per path, the first unassigned bucket whose
residual element count fits ``ecap``; later rounds re-cut the residue
until the top fits. Treelet 0 is the final top residue; the traversal
starts at (root_tid, col 0).

XLA primitives without a direct torch counterpart: ``nonzero(size=,
fill_value=)`` is a truncate-and-pad, ``.at[].set(mode="drop")`` a store
of the in-range rows only (the reference's trash row is sliced off
anyway), ``bitcast_convert_type`` a ``.view``. The reference's jit caches
have no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_raytracing_torch.bvh.bucket import _range_lookup, _range_min_table, leaf_major_tables
from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_INST, CHILD_NONE, CHILD_TRI
from tpu_raytracing_torch.trace.traverse import _META_CHILD_SHIFT, PackedPairs, f2i, i2f

_F32_MAX = float(torch.finfo(torch.float32).max)
ECAP = 128          # elements per treelet
INNER_WIDTH = 8     # entries per inner element
_BIG = 2 ** 30


class TreeletCapacityError(RuntimeError):
    """The build overflowed one of its static bounds (treelet count or
    per-treelet element budget) and dropped geometry."""

    def __init__(self, msg: str, column_overflow: bool = False):
        super().__init__(msg)
        # True when a treelet exceeded its ecap element budget: a bigger
        # tcap cannot help, so retry loops re-raise.
        self.column_overflow = column_overflow


@dataclasses.dataclass
class TreeletBVH:
    """See the module docstring.

    tables [TCAP, WH, ECAP] f32; columns [TCAP, ECAP, WH] f32, equal to
    ``tables.transpose(1, 2)`` and contiguous (each column's WH words in a
    row); num_treelets, root_tid, max_col, num_leaves [] int; pair_tid [n]
    int32, the treelet id of the window holding each sorted pair (the
    ``tid`` bounce-sort key).
    """

    tables: torch.Tensor
    columns: torch.Tensor
    num_treelets: torch.Tensor
    root_tid: torch.Tensor
    max_col: torch.Tensor
    num_leaves: torch.Tensor
    pair_tid: Optional[torch.Tensor] = None
    leaf_width: int = 16

    @property
    def wh(self) -> int:
        return self.tables.shape[1]


def table_words(leaf_width: int) -> int:
    """Column height: 12*lw pair words + 1 gstart row, rounded up to 8,
    with a floor of 64 for the inner layout."""
    return max(-(-(12 * leaf_width + 1) // 8) * 8, 64)


def _head_fill(x, heads, reverse: bool = False):
    """Running max of x at head positions along dim 1 (running min from
    the right when ``reverse``): a forward fill from heads where the head
    values rise along the row."""
    if reverse:
        src = torch.where(heads, x, _BIG)
        return torch.cummin(src.flip(1), dim=1).values.flip(1)
    return torch.cummax(torch.where(heads, x, -_BIG), dim=1).values


def _exclusive_cumsum(x, dim: int = -1):
    return torch.cumsum(x, dim=dim) - x


def _under_counts(row_mask, w_mask, heads):
    """Rows-under and windows-under per (level, leaf), from exclusive
    prefix sums and head fills: the value at the bucket's start gives the
    count before it, the value at the next head the count before its end."""
    L, n = heads.shape
    dev = heads.device
    w_i = w_mask.to(torch.int64)
    wcum = _exclusive_cumsum(w_i)
    num_windows = w_i.sum()
    wcum_l = wcum[None, :].expand(L, n)
    w_at_start = _head_fill(wcum_l, heads)
    nxt_fill = _head_fill(wcum_l, heads, reverse=True)
    big_col = torch.full((L, 1), _BIG, dtype=torch.int64, device=dev)
    w_at_end = torch.minimum(torch.cat([nxt_fill[:, 1:], big_col], dim=1), num_windows)
    wins_under = w_at_end - w_at_start

    rm = row_mask.to(torch.int64)
    rc = torch.cumsum(rm, dim=1)
    # suffix over levels strictly below l (a bucket's descendant rows)
    rc_suffix = torch.cumsum(rc.flip(0), dim=0).flip(0)
    zeros_row = torch.zeros((1, n), dtype=torch.int64, device=dev)
    sr = torch.cat([rc_suffix[1:], zeros_row], dim=0)
    # exclusive form: deeper rows can head at the bucket's own start leaf
    sr_ex = torch.cat([torch.zeros((L, 1), dtype=torch.int64, device=dev), sr[:, :-1]], dim=1)
    s_at_start = _head_fill(sr_ex, heads)
    s_fill = _head_fill(sr_ex, heads, reverse=True)
    s_at_end = torch.cat([s_fill[:, 1:], big_col], dim=1)
    # at the array end the next-head fill saturates: clamp to the totals
    lvl_tot = torch.cumsum(rm.sum(dim=1).flip(0), dim=0).flip(0)
    lvl_tot = torch.cat([lvl_tot[1:], torch.zeros((1,), dtype=torch.int64, device=dev)])
    s_at_end = torch.minimum(s_at_end, lvl_tot[:, None])
    return s_at_end - s_at_start, wins_under


def _tids_top_down(troot, tid_dense):
    """tid per (level, leaf): the nearest treelet-root ancestor-or-self."""
    tids = [torch.where(troot[0], tid_dense[0], 0)]
    for l in range(1, troot.shape[0]):
        tids.append(torch.where(troot[l], tid_dense[l], tids[-1]))
    return torch.stack(tids, dim=0)


def _none_above(mask):
    """[L, n]: True where no level strictly above holds a True in the
    same column (a cumprod of the shifted negation)."""
    n = mask.shape[1]
    ones = torch.ones((1, n), dtype=torch.bool, device=mask.device)
    return torch.cumprod(torch.cat([ones, ~mask[:-1]], dim=0).to(torch.int64),
                         dim=0).to(torch.bool)


def _classification(heads, counts, num_leaves, n: int, lw: int, ecap: int = ECAP):
    """All dense [L, n] classification shared by count and build; see the
    module docstring for the multi-round cut. (The reference's unused
    ``max_rounds`` cap is not ported.)"""
    L = heads.shape[0]
    dev = heads.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    live = iota < num_leaves

    small = (counts >= 1) & (counts <= lw)
    chain = torch.cat([counts[:-1] == counts[1:],
                       torch.ones((1, n), dtype=torch.bool, device=dev)], dim=0)
    branch = (counts > lw) & ~chain
    alive = _none_above(small)
    real = alive & branch

    # window per leaf: the unique (alive & small) bucket on its root path
    wstart = (heads & alive & small).any(dim=0) & live
    rmask = heads & real & live[None, :]

    # each round shrinks the unassigned upper tree by well over 16x
    rounds = max(1, math.ceil(math.log(max(n, 4)) / math.log(16)))
    troot_tot = torch.zeros((L, n), dtype=torch.bool, device=dev)
    tid_dense_tot = torch.zeros((L, n), dtype=torch.int64, device=dev)
    base = torch.ones((), dtype=torch.int64, device=dev)  # tid 0 = final top residue
    for _ in range(rounds):
        tid_cur = _tids_top_down(troot_tot, tid_dense_tot)
        # residual (unassigned) rows and windows only; assigned subtrees
        # cost their parent a portal entry, not a column
        row_un = rmask & (tid_cur == 0)
        w_un = wstart & (tid_cur[L - 1] == 0)
        rows_under, wins_under = _under_counts(row_un, w_un, heads)
        elems = rows_under + wins_under + 1
        cand = real & (tid_cur == 0) & (elems <= ecap)
        # within a round, the shallowest fitting bucket per path wins
        troot_r = cand & _none_above(cand)
        tmask = heads & troot_r & live[None, :]

        tm = tmask.to(torch.int64)
        per_level = tm.sum(dim=1)
        offs = base + torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                                 torch.cumsum(per_level, 0)[:-1]])
        tid_r = offs[:, None] + torch.cumsum(tm, dim=1) - 1
        tid_r = _head_fill(torch.where(tmask, tid_r, 0), heads)
        troot_tot = troot_tot | troot_r
        tid_dense_tot = torch.where(troot_r, tid_r, tid_dense_tot)
        base = base + tm.sum()

    tid_cur = _tids_top_down(troot_tot, tid_dense_tot)
    return dict(L=L, live=live, small=small, chain=chain, branch=branch, alive=alive,
                real=real, wstart=wstart, rmask=rmask, troot=troot_tot, tid_cur=tid_cur,
                num_treelets=base)


def _front_classification(front, leaf_width: int, ecap: int):
    sorted_codes, num_leaves = front[0], front[5]
    n = sorted_codes.shape[0]
    heads, _starts, _nxts, counts = leaf_major_tables(sorted_codes, num_leaves, n, INNER_WIDTH)
    return heads, counts, _classification(heads, counts, num_leaves, n, leaf_width, ecap)


def treelet_capacity(front, leaf_width: int = 16, ecap: int = ECAP) -> int:
    """The front's treelet count (a host sync), for sizing ``tcap``."""
    return int(_front_classification(front, leaf_width, ecap)[2]["num_treelets"])


def _nonzero_padded(mask, size: int, fill: int):
    """``jnp.nonzero(mask, size=size, fill_value=fill)``."""
    idx = torch.nonzero(mask).reshape(-1)[:size]
    pad = torch.full((size - idx.shape[0],), fill, dtype=torch.int64, device=mask.device)
    return torch.cat([idx, pad])


def _run_rank(keys, sentinel: int):
    """Rank of each element within its run of equal consecutive keys."""
    m = keys.shape[0]
    idx = torch.arange(m, dtype=torch.int64, device=keys.device)
    prev = torch.cat([torch.full((1,), sentinel, dtype=keys.dtype, device=keys.device),
                      keys[:-1]])
    return idx - torch.cummax(torch.where(keys != prev, idx, -1), dim=0).values


def _rank_within_tid(tids):
    """Rank of each element among those with the same tid, in index
    order (a stable sort by tid, ranked within runs, scattered back)."""
    order = torch.sort(tids, stable=True).indices
    ranked = _run_rank(tids[order], -1)
    out = torch.empty_like(ranked)
    out[order] = ranked
    return out


def _empty_inner_column(device):
    """Inner column words with every entry's box inverted (never hit)."""
    lo = f2i(torch.full((24,), _F32_MAX, dtype=torch.float32, device=device))
    hi = f2i(torch.full((24,), -_F32_MAX, dtype=torch.float32, device=device))
    return torch.cat([lo, hi, torch.zeros((16,), dtype=torch.int32, device=device)])


def build_treelet(front, tcap: int, leaf_width: int = 16,
                  ecap: int = ECAP) -> Tuple[TreeletBVH, PackedPairs]:
    """Build the TreeletBVH from a ``bucket.split_front`` result.

    ``tcap`` is the static treelet capacity; ``check_treelet_capacity``
    validates it. ``ecap`` is 128 for the kernel's tables; tests pass a
    small value to force the multi-round cut at small scene sizes.
    """
    lw = leaf_width
    if lw < INNER_WIDTH:
        raise ValueError(f"leaf_width {lw} < inner width {INNER_WIDTH}")
    wh = table_words(lw)
    sorted_codes, packed, _lo, _hi, _cc, num_leaves = front
    n = sorted_codes.shape[0]
    dev = sorted_codes.device
    i64 = dict(dtype=torch.int64, device=dev)
    iota = torch.arange(n, **i64)
    live = iota < num_leaves
    packed = PackedPairs(rows=torch.where(live[:, None], packed.rows, 0))

    heads, starts, _nxts, counts = leaf_major_tables(sorted_codes, num_leaves, n, INNER_WIDTH)
    cls = _classification(heads, counts, num_leaves, n, lw, ecap)
    L = cls["L"]
    small, branch, alive, real = cls["small"], cls["branch"], cls["alive"], cls["real"]
    wstart, rmask, tid_cur = cls["wstart"], cls["rmask"], cls["tid_cur"]

    # ---- compacted row list (level-major) ----
    rcap = max(n // (2 * lw) * 4, 256) + 64
    rflat = rmask.reshape(-1)
    rsize = rflat.shape[0]
    ridx = _nonzero_padded(rflat, rcap, rsize)
    r_valid = ridx < rsize
    ridx_c = torch.clamp(ridx, max=rsize - 1)
    r_tid = torch.where(r_valid, tid_cur.reshape(-1)[ridx_c], tcap)
    # local col: rows are level-major, so a treelet's root row ranks 0
    r_col = _rank_within_tid(r_tid)

    # rows per treelet (window cols come after the rows)
    rows_of_tid = torch.zeros((tcap + 1,), **i64).index_add_(
        0, torch.clamp(r_tid, max=tcap), r_valid.to(torch.int64))

    # dense row rank (level-major, the compaction order) for entry targets
    rm = rmask.to(torch.int64)
    lvl_off = torch.cat([torch.zeros((1,), **i64), torch.cumsum(rm.sum(dim=1), 0)[:-1]])
    rank_dense = lvl_off[:, None] + _exclusive_cumsum(rm, dim=1) + rm - 1
    rank_dense = _head_fill(torch.where(rmask, rank_dense, 0), heads)

    # window index per (level, leaf): exclusive wstart count at the bucket start
    ws = wstart.to(torch.int64)
    widx_dense = _head_fill(_exclusive_cumsum(ws)[None, :].expand(L, n), heads)

    # ---- effective targets, bottom-up (chains skipped); tag = idx << 1 | is_window
    win_tag = (widx_dense << 1) | 1
    row_tag = rank_dense << 1
    eff = win_tag[L - 1]
    effs = [None] * L
    effs[L - 1] = eff
    for l in range(L - 2, -1, -1):
        eff = torch.where(small[l], win_tag[l], torch.where(real[l], row_tag[l], eff))
        effs[l] = eff
    effs = torch.stack(effs, dim=0)

    # ---- compacted window list (leaf order == widx order) ----
    wcap = max(n, 256)
    widx_pos = _nonzero_padded(wstart, wcap, n)
    w_valid = widx_pos < n
    w_pos = torch.clamp(widx_pos, max=n - 1)
    # the window's level: the unique alive & small level at its start leaf
    w_lvl = torch.argmax((heads & alive & small).to(torch.int32), dim=0)[w_pos]
    w_tid = torch.where(w_valid, tid_cur[w_lvl, w_pos], tcap)
    w_count = torch.where(w_valid, counts[w_lvl, w_pos], 0)
    # windows are not tid-grouped in leaf order: rank within tid by a sort
    w_col = rows_of_tid[torch.clamp(w_tid, max=tcap)] + _rank_within_tid(w_tid)

    # ---- compacted entry list (as emit_split) ----
    emask = heads[1:] & (alive[:-1] & branch[:-1]) & live[None, :]
    elcap = min(rcap * INNER_WIDTH, (L - 1) * n)
    eflat = emask.reshape(-1)
    esize = eflat.shape[0]
    eidx = _nonzero_padded(eflat, elcap, esize)
    e_valid = eidx < esize
    gidx = torch.clamp(eidx, max=esize - 1) + n  # into [L, n] (emask drops level 0)
    e_start = starts.reshape(-1)[gidx]
    e_count = counts.reshape(-1)[gidx]
    e_eff = effs.reshape(-1)[gidx]
    par_rank = rank_dense.reshape(-1)[gidx - n]
    par_tid = tid_cur.reshape(-1)[gidx - n]
    # slot within the parent row: consecutive entries share the parent
    e_j = _run_rank(par_rank, -2)

    # resolve entry targets (rank == index into the compacted row list)
    is_win = (e_eff & 1) == 1
    tgt = e_eff >> 1
    tgt_w = torch.clamp(tgt, max=wcap - 1)
    tgt_r = torch.clamp(tgt, max=rcap - 1)
    trow_tid = r_tid[tgt_r]
    portal = ~is_win & (trow_tid != par_tid)
    child = torch.where(is_win, w_col[tgt_w], torch.where(portal, trow_tid, r_col[tgt_r]))
    etype = torch.where(is_win, CHILD_TRI, torch.where(portal, CHILD_INST, CHILD_BOX))
    meta = ((child << _META_CHILD_SHIFT) | etype).to(torch.int32)
    meta = torch.where(e_valid, meta, CHILD_NONE)

    # entry AABBs from the zeroed pair rows
    v = i2f(packed.rows[:, :12]).reshape(-1, 4, 3)
    leaf_lo = v.amin(dim=1)
    leaf_hi = v.amax(dim=1)
    e_lo, e_hi = _range_lookup(_range_min_table(leaf_lo, leaf_hi), e_start, e_count)

    # ---- inner columns [rcap, 64] (word w of entry e at w*8 + e) ----
    empty = _empty_inner_column(dev)
    inner_cols = empty.repeat(rcap, 1)
    ok_e = e_valid & (e_j >= 0) & (e_j < INNER_WIDTH) & (par_rank < rcap)
    rows_e, slot_e = par_rank[ok_e], e_j[ok_e]
    words_e = [f2i(e_lo[:, 0]), f2i(e_lo[:, 1]), f2i(e_lo[:, 2]),
               f2i(e_hi[:, 0]), f2i(e_hi[:, 1]), f2i(e_hi[:, 2]), meta]
    for w, word in enumerate(words_e):
        inner_cols[rows_e, w * 8 + slot_e] = word[ok_e]
    max_col = torch.where(r_valid, r_col, 0).max()

    # ---- window columns [wcap, 12*lw + 1] (pair words transposed) ----
    lanes = torch.arange(lw, **i64)
    wrows = packed.rows[torch.clamp(w_pos[:, None] + lanes[None, :], max=n - 1)]
    wrows = torch.where((lanes[None, :] < w_count[:, None])[:, :, None], wrows, 0)
    wcols = wrows[:, :, :12].transpose(1, 2).reshape(wcap, 12 * lw)
    wcols = torch.cat([wcols, w_pos[:, None].to(torch.int32)], dim=1)
    max_col = torch.maximum(max_col, torch.where(w_valid, w_col, 0).max())

    # ---- scatter columns into the [tcap * ecap, wh] table ----
    table = torch.zeros((tcap * ecap, wh), dtype=torch.int32, device=dev)
    ok_r = r_valid & (r_col < ecap)
    dest_i = torch.clamp(r_tid, max=tcap - 1) * ecap + r_col
    table[dest_i[ok_r], :64] = inner_cols[ok_r]
    ok_w = w_valid & (w_col < ecap)
    dest_w = torch.clamp(w_tid, max=tcap - 1) * ecap + w_col
    table[dest_w[ok_w], :12 * lw + 1] = wcols[ok_w]
    columns = i2f(table).reshape(tcap, ecap, wh)

    # ---- root: if the level-0 bucket is a window (tiny scene), a single-
    # entry inner column at (tid 0, col 0) points at the window in col 1.
    root_eff = effs[0, 0]
    root_is_win = (root_eff & 1) == 1
    root_tid = torch.where(root_is_win, 0, tid_cur[0, 0])
    smin = torch.where(live[:, None], leaf_lo, _F32_MAX).amin(dim=0)
    smax = torch.where(live[:, None], leaf_hi, -_F32_MAX).amax(dim=0)
    tiny_col = empty.clone()
    tiny_col[0:48:8] = f2i(torch.cat([smin, smax]))
    tiny_col[48] = (1 << _META_CHILD_SHIFT) | CHILD_TRI
    pad_i = torch.zeros((wh - 64,), dtype=torch.int32, device=dev)
    tiny_if = i2f(torch.cat([tiny_col, pad_i]))
    pad_w = torch.zeros((wh - (12 * lw + 1),), dtype=torch.int32, device=dev)
    tiny_win = i2f(torch.cat([wcols[0], pad_w]))
    columns[0, 0] = torch.where(root_is_win, tiny_if, columns[0, 0])
    columns[0, 1] = torch.where(root_is_win, tiny_win, columns[0, 1])
    tables = columns.transpose(1, 2).contiguous()

    # pair -> owning window's treelet id: windows tile the live pair range
    # contiguously in leaf order
    seg = torch.cummax(torch.where(wstart, iota, -1), dim=0).values
    tid_at = torch.zeros((n,), **i64)
    tid_at[w_pos[w_valid]] = w_tid[w_valid]
    pair_tid = tid_at[torch.clamp(seg, min=0)].to(torch.int32)

    tb = TreeletBVH(tables=tables, columns=columns, num_treelets=cls["num_treelets"],
                    root_tid=root_tid.to(torch.int32), max_col=max_col,
                    num_leaves=num_leaves, pair_tid=pair_tid, leaf_width=lw)
    return tb, packed


def build_pair_tid(front, leaf_width: int = 16, ecap: int = ECAP):
    """[n] int32 pair -> treelet id from the classification alone, without
    the tables: the ``tid`` bounce sort's key. Equals ``TreeletBVH.pair_tid``."""
    heads, _counts, cls = _front_classification(front, leaf_width, ecap)
    n = heads.shape[1]
    wstart, tid_cur = cls["wstart"], cls["tid_cur"]
    iota = torch.arange(n, dtype=torch.int64, device=heads.device)
    w_lvl = torch.argmax((heads & cls["alive"] & cls["small"]).to(torch.int32), dim=0)
    wtid_dense = tid_cur.gather(0, w_lvl[None, :])[0]
    seg = torch.cummax(torch.where(wstart, iota, -1), dim=0).values
    return torch.where(seg >= 0, wtid_dense[torch.clamp(seg, min=0)], 0).to(torch.int32)


def build_treelet_auto(front, leaf_width: int = 16, pairs_per_treelet: int = 140,
                       headroom: int = 64) -> Tuple[TreeletBVH, PackedPairs]:
    """Production build: ``tcap`` from the live pair count (about 140 pairs
    per treelet at 1M, with margin), validated by ``check_treelet_capacity``
    and doubled on a retryable overflow, at most three builds."""
    num_leaves = int(front[5])
    tcap = max(num_leaves // pairs_per_treelet + headroom, 64)
    last = None
    for _ in range(3):
        tb, packed = build_treelet(front, tcap, leaf_width=leaf_width)
        try:
            check_treelet_capacity(tb)
            return tb, packed
        except TreeletCapacityError as e:
            last = e
            if e.column_overflow:
                raise  # element overflow: a bigger tcap cannot help
            tcap *= 2
    raise last


def check_treelet_capacity(tb: TreeletBVH) -> None:
    """Raise TreeletCapacityError if the build overflowed its static bounds
    (dropped elements would lose geometry). A tcap overflow is checked
    first: overflowed tids clamp into the last treelet and can also show as
    a column overflow, and the retryable kind must win."""
    nt = int(tb.num_treelets)
    mc = int(tb.max_col)
    tcap, _, ecap = tb.tables.shape
    if nt > tcap:
        raise TreeletCapacityError(
            f"TreeletBVH overflow: {nt} treelets > static capacity {tcap}; rebuild "
            f"with a larger tcap (bvh/treelet.py:build_treelet)")
    if mc >= ecap:
        raise TreeletCapacityError(
            f"TreeletBVH column overflow: an element wanted col {mc} >= {ecap}: a "
            f"treelet exceeded its element budget; geometry was dropped",
            column_overflow=True)


def reference_walk(tb: TreeletBVH, rays_o, rays_d, tmin, tmax):
    """Closest hit over the treelet tables by a host DFS in float64 numpy,
    independent of the kernel. Returns (t, tri_id) arrays, tri_id -1 on a
    miss. Slow: tests only."""
    tables = tb.tables.detach().cpu().numpy()
    tables_i = tables.view(np.int32)
    lw = tb.leaf_width
    root_tid = int(tb.root_tid)
    nrays = rays_o.shape[0]
    out_t = np.asarray(tmax, dtype=np.float32).copy()
    out_tri = np.full((nrays,), -1, np.int64)

    def slab(o, inv, lo, hi, tmn, tmx):
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        near = np.minimum(t0, t1).max()
        far = np.maximum(t0, t1).min()
        return (far >= near) and (near <= tmx) and (far >= tmn), max(near, 0.0)

    def moller_trumbore(o, d, a, b, c):
        e1, e2 = b - a, c - a
        h = np.cross(d, e2)
        det = np.dot(e1, h)
        if abs(det) < 1e-9:
            return None
        f = 1.0 / det
        sv = o - a
        u = f * np.dot(sv, h)
        q = np.cross(sv, e1)
        vv = f * np.dot(d, q)
        if 0 <= u <= 1 and vv >= 0 and u + vv <= 1:
            return f * np.dot(e2, q)
        return None

    for r in range(nrays):
        o = np.asarray(rays_o[r], np.float64)
        d = np.asarray(rays_d[r], np.float64)
        inv = 1.0 / np.where(np.abs(d) < 1e-30, 1e-30, d)
        tmn = float(tmin[r])
        stack = [(root_tid, 0, 0)]  # (tid, col, kind 0 inner / 1 window)
        while stack:
            tid, col, kind = stack.pop()
            tab, tab_i = tables[tid], tables_i[tid]
            if kind == 1:
                gstart = int(tab_i[12 * lw, col])
                for p in range(lw):
                    v = np.array([tab[w * lw + p, col] for w in range(12)], np.float64)
                    for second, (a, b, c) in enumerate(((v[0:3], v[3:6], v[6:9]),
                                                        (v[6:9], v[3:6], v[9:12]))):
                        t = moller_trumbore(o, d, a, b, c)
                        if t is not None and tmn <= t <= out_t[r]:
                            out_t[r] = t
                            out_tri[r] = (gstart + p) * 2 + second
                continue
            # inner: visit entries nearest first (the higher id wins ties)
            cand = []
            for e in range(INNER_WIDTH):
                meta = int(tab_i[48 + e, col])
                etype = meta & 3
                if etype == 0:
                    continue
                lo3 = np.array([tab[w * 8 + e, col] for w in range(3)], np.float64)
                hi3 = np.array([tab[w * 8 + e, col] for w in range(3, 6)], np.float64)
                hit, near = slab(o, inv, lo3, hi3, tmn, out_t[r])
                if hit:
                    cand.append((near, -e, meta, etype))
            for _near, _nege, meta, etype in sorted(cand, reverse=True):
                child = meta >> _META_CHILD_SHIFT
                if etype == CHILD_TRI:
                    stack.append((tid, child, 1))
                elif etype == CHILD_BOX:
                    stack.append((tid, child, 0))
                else:  # portal
                    stack.append((child, 0, 0))
    return out_t, out_tri
