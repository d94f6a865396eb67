"""Uniform-grid accelerator: the structure of the app's ``--tracer grid``.

Port of ``tpu_raytracing/bvh/grid.py`` (``_dist_transform``,
``tier_params``, ``UniformGrid``, ``_grid_res``, ``_big_cap``,
``auto_res3``, ``_tri_cell_overlap``, ``build_grid``,
``check_grid_capacity``, ``build_grid_from_triangles``). Every field is
bit-equal to the reference's.

Layout:

* ``refs``: pair-row ids (``trace/traverse.py:PackedPairs`` rows) sorted by
  cell id; cell c's references are the run
  ``[cell_start[c], cell_start[c] + cell_count[c])``.
* A row whose box covers at most ``k`` cells references each cell its
  triangles touch (a separating-axis test drops the cells only its box
  touches); a row covering at most ``k2`` cells goes through a second,
  compacted tier of at most ``P // med_frac`` rows; a larger row joins the
  "big list" that every ray tests once. Rows and refs past these static
  bounds add to ``overflow``, which ``check_grid_capacity`` raises on.
* ``cell_word`` packs each cell's count with its capped L-inf distance to
  the nearest nonempty cell (``count | dist << DIST_SHIFT``), which the
  tracer's empty-space skip reads.

As in the reference, the static sizes (``nonzero(size=...)`` pads or cuts
to them) come from the row count, and the sort of the cell keys is
stable, so ``refs`` keeps the reference's order within a cell.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_raytracing_torch.bvh.sah import _fma, setup_leaves
from tpu_raytracing_torch.trace.traverse import PackedPairs, pack_pairs

_F32_MAX = float(torch.finfo(torch.float32).max)

# cell_word packing: low bits the ref count, high bits the capped L-inf
# distance to the nearest nonempty cell. A count stays below
# 1 << DIST_SHIFT (it is bounded by the ref table's size, checked in
# build_grid), so the fields never collide.
DIST_SHIFT = 27
DCAP = 15  # the skip radius's cap

# Cells a row may reference directly, and through the medium tier; larger
# rows join the big list. tier_params widens the medium tier for finer
# cells.
K_FOOTPRINT = 8
K2_FOOTPRINT = 32


def _dist_transform(occ3: torch.Tensor) -> torch.Tensor:
    """Capped L-inf distance transform of a [gz, gy, gx] occupancy mask:
    out[c] = min(DCAP, distance to the nearest True cell), by DCAP rounds
    of a radius-1 separable min filter (a shifted min along each axis)."""
    d = torch.where(occ3, 0, DCAP).to(torch.int32)

    def shifted_min(a: torch.Tensor, axis: int) -> torch.Tensor:
        n = a.shape[axis]
        cap = torch.full_like(a.narrow(axis, 0, 1), DCAP)
        fwd = torch.cat([cap, a.narrow(axis, 0, n - 1)], dim=axis)
        bwd = torch.cat([a.narrow(axis, 1, n - 1), cap], dim=axis)
        return torch.minimum(a, torch.minimum(fwd, bwd))

    for _ in range(DCAP):
        e = d
        for axis in range(3):
            e = shifted_min(e, axis)
        d = torch.minimum(d, e + 1)
    return d


def tier_params(scale: float) -> dict:
    """The footprint tiers' sizes for a cell scale: footprints grow about
    1/scale^2 as cells shrink, so scales below 1 widen the medium tier
    (``k2``) and deepen its row budget (``med_frac``)."""
    return dict(
        k=K_FOOTPRINT,
        k2=max(K2_FOOTPRINT, int(K2_FOOTPRINT / (scale * scale))),
        med_frac=16 if scale >= 1.0 else 4,
    )


@dataclasses.dataclass
class UniformGrid:
    cell_start: torch.Tensor  # [G^3 + 1] int32: first ref of cell c
    cell_count: torch.Tensor  # [G^3 + 1] int32
    refs: torch.Tensor  # [RCAP] int32: pair-row ids sorted by cell
    big: torch.Tensor  # [BCAP] int32: row ids every ray tests
    num_big: torch.Tensor  # [] int32: live prefix of big
    overflow: torch.Tensor  # [] int32: rows and refs past the static bounds
    grid_min: torch.Tensor  # [3] f32
    grid_max: torch.Tensor  # [3] f32
    cell_size: torch.Tensor  # [3] f32
    cell_word: torch.Tensor  # [G^3 + 1] int32: count | dist << DIST_SHIFT
    # per-axis resolution (gx, gy, gz), a host tuple: the linear cell id is
    # (z * gy + y) * gx + x
    res: Tuple[int, int, int] = (64, 64, 64)


def _grid_res(num_rows: int, density: float = 4.0) -> int:
    """Cells ~ density * rows, clamped so the cell tables stay small."""
    g = int(round((density * max(num_rows, 1)) ** (1.0 / 3.0)))
    return max(8, min(g, 160))


def _big_cap(num_rows: int) -> int:
    return max(64, num_rows // 256)


def auto_res3(span, num_rows: int, scale: float = 1.0) -> Tuple[int, int, int]:
    """Per-axis resolution on the host: cubic cells of size
    (largest span / _grid_res(num_rows)) * scale, each axis sized to its own
    ``span`` (the scene's extent)."""
    span = np.maximum(np.asarray(span, np.float64), 1e-6)
    s = float(span.max()) / _grid_res(num_rows) * scale
    return tuple(int(np.clip(np.ceil(a / s), 1, 512)) for a in span)


def _tri_cell_overlap(v, clo_k, gmin, cs):
    """Separating-axis overlap of both triangles of each pair row with cell
    ``clo_k`` ([P, 3] int): the two face normals and the nine edge
    cross-axes of each triangle (the box axes passed the footprint test).
    v: [P, 4, 3] pair vertices. Returns [P] bool.

    Each multiply that XLA's CPU compiler fuses into the add consuming it
    rounds once here too (``_fma``): a sum of three products is
    fma(z, z', fma(x, x', y * y')), a difference of two fma(x, x', -(y * y'))."""
    c = _fma(clo_k.to(torch.float32) + 0.5, cs[None, :], gmin[None, :])
    h = 0.5 * cs[None, :]

    def sum3(a, b):
        return _fma(a[2], b[2], _fma(a[0], b[0], a[1] * b[1]))

    def tri_hits(a, b, cvtx):
        p0, p1, p2 = a - c, b - c, cvtx - c
        e0, e1, e2 = p1 - p0, p2 - p1, p0 - p2
        hs = (h[:, 0], h[:, 1], h[:, 2])
        ok = torch.ones((v.shape[0],), dtype=torch.bool, device=v.device)
        for e in (e0, e1, e2):
            ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
            zero = torch.zeros_like(ex)
            for axis in ((zero, -ez, ey), (ez, zero, -ex), (-ey, ex, zero)):
                d0, d1, d2 = (sum3(axis, p.unbind(dim=1)) for p in (p0, p1, p2))
                r = sum3(hs, tuple(a.abs() for a in axis))
                lo = torch.minimum(torch.minimum(d0, d1), d2)
                hi = torch.maximum(torch.maximum(d0, d1), d2)
                ok &= (lo <= r) & (hi >= -r)
        nx = _fma(e0[:, 1], e1[:, 2], -(e0[:, 2] * e1[:, 1]))
        ny = _fma(e0[:, 2], e1[:, 0], -(e0[:, 0] * e1[:, 2]))
        nz = _fma(e0[:, 0], e1[:, 1], -(e0[:, 1] * e1[:, 0]))
        n = (nx, ny, nz)
        d = sum3(n, p0.unbind(dim=1))
        r = sum3(hs, tuple(a.abs() for a in n))
        ok &= d.abs() <= r
        return ok

    return tri_hits(v[:, 0], v[:, 1], v[:, 2]) | tri_hits(v[:, 2], v[:, 1], v[:, 3])


def _nonzero_padded(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)``: the first ``size``
    indices of True in order, padded with ``fill``; int64."""
    idx = torch.nonzero(mask).reshape(-1)[:size]
    if idx.numel() < size:
        idx = torch.cat([idx, torch.full((size - idx.numel(),), fill, dtype=idx.dtype,
                                         device=idx.device)])
    return idx


def _cell_index(x: torch.Tensor, gvec: torch.Tensor) -> torch.Tensor:
    """``clip(floor(x).astype(int32), 0, g - 1)`` per axis with XLA's
    saturating conversion (NaN -> 0): clamp in float, then truncate."""
    x = torch.nan_to_num(torch.floor(x), nan=0.0)
    return torch.minimum(torch.clamp(x, min=0.0), (gvec - 1).to(torch.float32)).to(torch.int32)


def build_grid(rows: torch.Tensor, num_live, res=None, k: int = K_FOOTPRINT,
               k2: int = K2_FOOTPRINT, med_frac: int = 16,
               compact_cap: Optional[int] = None) -> UniformGrid:
    """The grid over the live pair rows ([P, 16] int32, vertex words 0-11;
    ``num_live``, an int or a 0-d tensor, is the live prefix). ``res`` is
    None (a cubic grid of ``_grid_res(P)`` cells a side), an int or a
    per-axis (gx, gy, gz); equal counts cubify the box, per-axis counts
    size each axis to its own span. ``k``, ``k2`` and ``med_frac`` size the
    footprint tiers (``tier_params``); ``compact_cap`` bounds the live-key
    compaction before the sort (None: max(6 P, 4096); 0: none)."""
    p = rows.shape[0]
    dev = rows.device
    if res is None:
        g0 = _grid_res(p)
        res3 = (g0, g0, g0)
    elif isinstance(res, int):
        res3 = (res, res, res)
    else:
        res3 = tuple(int(r) for r in res)
    gx, gy, gz = res3
    g3 = gx * gy * gz
    gvec = torch.tensor(res3, dtype=torch.int32, device=dev)
    bcap = _big_cap(p)
    iota = torch.arange(p, dtype=torch.int32, device=dev)
    live = iota < num_live

    v = rows[:, :12].contiguous().view(torch.float32).reshape(-1, 4, 3)
    lo = v.amin(dim=1)
    hi = v.amax(dim=1)
    gmin = torch.where(live[:, None], lo, _F32_MAX).amin(dim=0)
    gmax = torch.where(live[:, None], hi, -_F32_MAX).amax(dim=0)
    span = torch.clamp(gmax - gmin, min=1e-6)
    if res3[0] == res3[1] == res3[2]:
        # a cubified box: cubic cells, the padded axes empty table rows
        cube = span.max()
        gmax = gmin + cube
        pad_eps = cube
    else:
        pad_eps = span.max()
    # grow the box slightly so boundary vertices bin strictly inside
    gmin = gmin - pad_eps * 1e-4
    gmax = gmax + pad_eps * 1e-4
    # XLA turns the division by the constant counts into a product with
    # their float32 reciprocals
    cs = (gmax - gmin) * (1.0 / gvec.to(torch.float32))
    inv_cs = 1.0 / cs

    clo = _cell_index((lo - gmin) * inv_cs, gvec)
    chi = _cell_index((hi - gmin) * inv_cs, gvec)
    dx = chi[:, 0] - clo[:, 0] + 1
    dy = chi[:, 1] - clo[:, 1] + 1
    dz = chi[:, 2] - clo[:, 2] + 1
    total = dx * dy * dz
    is_med = live & (total > k) & (total <= k2)
    is_big = live & (total > k2)
    direct = live & (total <= k)

    def slot_cells(kk, clo_, dx_, dy_):
        kx = kk % dx_
        ky = torch.div(kk, dx_, rounding_mode="floor") % dy_
        kz = torch.div(kk, dx_ * dy_, rounding_mode="floor")
        clo_k = clo_ + torch.stack([kx, ky, kz], dim=1)
        cell = (clo_k[:, 2] * gy + clo_k[:, 1]) * gx + clo_k[:, 0]
        return clo_k, cell

    # direct refs: k static slots a row, the sentinel key g3 where unused;
    # a multi-cell footprint keeps only the cells its triangles touch
    keys = []
    for ki in range(k):
        kk = torch.full_like(dx, ki)
        clo_k, cell = slot_cells(kk, clo, dx, dy)
        ok = direct & (kk < total)
        ok &= (total == 1) | _tri_cell_overlap(v, clo_k, gmin, cs)
        keys.append(torch.where(ok, cell, g3))
    # the medium tier: compacted rows, k2 candidate slots each
    med_cap = max(p // med_frac, 256)
    midx = _nonzero_padded(is_med, med_cap, p)
    num_med = is_med.sum().to(torch.int32)
    mvalid = midx < p
    midx = midx.clamp(max=p - 1)
    mclo, mdx, mdy, mtotal, mv = clo[midx], dx[midx], dy[midx], total[midx], v[midx]
    mkeys = []
    for ki in range(k2):
        kk = torch.full_like(mdx, ki)
        mclo_k, cell = slot_cells(kk, mclo, mdx, mdy)
        ok = mvalid & (kk < mtotal) & _tri_cell_overlap(mv, mclo_k, gmin, cs)
        mkeys.append(torch.where(ok, cell, g3))

    key_flat = torch.cat(keys + mkeys)  # k-major: [k P + k2 M]
    row_flat = torch.cat([iota] * k + [midx.to(torch.int32)] * k2)

    # live-key compaction before the sort: sentinel keys are never read
    # downstream, so dropping them changes nothing live
    m0 = key_flat.shape[0]
    if compact_cap is None:
        compact_cap = max(6 * p, 4096)
    key_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if 0 < compact_cap < m0:
        livemask = key_flat < g3
        n_live = livemask.sum().to(torch.int32)
        cidx = _nonzero_padded(livemask, compact_cap, m0)
        safe_idx = cidx.clamp(max=m0 - 1)
        key_flat = torch.where(cidx < m0, key_flat[safe_idx], g3)
        row_flat = row_flat[safe_idx]
        key_overflow = torch.clamp(n_live - compact_cap, min=0)
    key_sorted, perm = torch.sort(key_flat, stable=True)
    refs = row_flat[perm]

    m = key_flat.shape[0]
    ridx = torch.arange(m, dtype=torch.int32, device=dev)
    heads = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       key_sorted[1:] != key_sorted[:-1]])
    # first position and run end of each present cell id (every head's key
    # is unique; non-heads all target the dropped slot g3 + 1)
    head_keys = key_sorted[heads].to(torch.int64)
    pos_of = torch.zeros((g3 + 2,), dtype=torch.int32, device=dev)
    pos_of[head_keys] = ridx[heads]
    nxt = torch.cat([torch.where(heads[1:], ridx[1:], m),
                     torch.full((1,), m, dtype=torch.int32, device=dev)])
    run_end = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    end_of = torch.zeros((g3 + 2,), dtype=torch.int32, device=dev)
    end_of[head_keys] = run_end[heads]
    cell_start = pos_of[: g3 + 1]
    cell_count = torch.clamp(end_of[: g3 + 1] - cell_start, min=0)
    cell_count[g3] = 0  # the sentinel cell answers out-of-range queries

    if refs.shape[0] >= (1 << DIST_SHIFT):
        raise ValueError(f"{refs.shape[0]} refs do not fit under 1 << {DIST_SHIFT}")
    occ3 = (cell_count[:g3] > 0).reshape(gz, gy, gx)
    dist = _dist_transform(occ3).reshape(-1)
    cell_word = torch.cat([cell_count[:g3] | (dist << DIST_SHIFT),
                           torch.zeros((1,), dtype=torch.int32, device=dev)])

    # the big list: rows every ray tests once
    bidx = _nonzero_padded(is_big, bcap, p)
    num_big = is_big.sum().to(torch.int32)
    overflow = (torch.clamp(num_big - bcap, min=0) + torch.clamp(num_med - med_cap, min=0)
                + key_overflow).to(torch.int32)
    big = bidx.clamp(max=p - 1).to(torch.int32)

    return UniformGrid(
        cell_start=cell_start, cell_count=cell_count, refs=refs, big=big,
        num_big=torch.clamp(num_big, max=bcap), overflow=overflow,
        grid_min=gmin, grid_max=gmax, cell_size=cs, cell_word=cell_word, res=res3)


def check_grid_capacity(grid: UniformGrid) -> None:
    """Host check: raises if rows or refs went past the medium, big or
    compaction bounds (dropped geometry). One host read."""
    ov = int(grid.overflow)
    if ov > 0:
        raise RuntimeError(
            f"UniformGrid capacity overflow: {ov} rows/refs past the medium/big/compaction "
            f"static bounds; raise _big_cap, the medium cap, compact_cap or the grid "
            f"resolution (bvh/grid.py)")


def build_grid_from_triangles(triangles: torch.Tensor, enable_pairs: bool = False, res=None,
                              k: int = K_FOOTPRINT, k2: int = K2_FOOTPRINT,
                              med_frac: int = 16, compact_cap: Optional[int] = None):
    """The grid from triangles: ``bvh/sah.py:setup_leaves`` pairing (no
    Morton sort: the cell-key sort orders everything), ``pack_pairs``, the
    rows past the live leaves zeroed, then ``build_grid``. Returns
    (UniformGrid, PackedPairs)."""
    leaves, pairs = setup_leaves(triangles, enable_pairs)
    rows = pack_pairs(pairs).rows
    iota = torch.arange(rows.shape[0], device=rows.device)
    rows = torch.where((iota < leaves.num_leaves)[:, None], rows, 0)
    grid = build_grid(rows, leaves.num_leaves, res=res, k=k, k2=k2, med_frac=med_frac,
                      compact_cap=compact_cap)
    return grid, PackedPairs(rows=rows)

