"""3D-DDA traversal of the uniform grid: the app's ``--tracer grid``.

Port of ``tpu_raytracing/trace/grid_trace.py`` (``_mt_cols``,
``trace_rays_grid``, ``make_grid_tracer``). Every ray first tests the big
list once, then walks the grid's cells front to back. Each iteration of
the walk tests up to ``block`` refs of the ray's current cell (the rest of
a full cell on later iterations) and then takes one DDA step, or, from an
empty cell whose packed distance D is at least 2, skips to just before its
(D - 1)-th boundary crossing on any axis (every cell it passes lies within
the L-inf ball the distance transform guarantees empty). A ray retires
when its best hit lies at or before the current cell's exit (no later cell
can beat it), when it leaves the grid or passes its tmax, or, in any-hit
mode, on its first accepted hit. Each iteration runs over the rays that
still walk, not over all of them.

Statistics are per ray: ``box_tests`` counts DDA iterations (cells
visited, drain steps included), ``tri_tests`` the Möller-Trumbore tests,
two a pair row, as the reference's.

``segments`` and ``residue_after`` / ``residue_width`` are the reference's
cures for its lockstep loop, which pays for its slowest ray across the
full width. Here they keep the reference's schedule (equal ray slices;
a bounded first phase, then the survivors in chunks run to completion),
and every ray still walks its own path, so hits and statistics equal the
single-phase loop's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.grid import DIST_SHIFT, UniformGrid
from tpu_raytracing_torch.bvh.sah import _fma
from tpu_raytracing_torch.trace.brute import HitRecord
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import PackedPairs, TraceStats, i2f, reconstruct

_F32_MAX = float(torch.finfo(torch.float32).max)
_TRI_EPS = 1e-9

# per-ray loop invariants and loop state of the walk
_CTX = ("ox", "oy", "oz", "dx", "dy", "dz", "invx", "invy", "invz", "stx", "sty", "stz",
        "tdx", "tdy", "tdz", "tmin", "nudge")
_STATE = ("cx", "cy", "cz", "tmx", "tmy", "tmz", "off", "done", "bt", "btr", "tt", "steps",
          "tfar")


def _mt_cols(pt, ox, oy, oz, dx, dy, dz, tmin, tmax):
    """Möller-Trumbore of both triangles of pair rows ``pt`` (12 vertex
    words, each [R] int32) against per-ray components (all [R]). Returns
    (t [R], enc [R]: the second triangle's flag, -1 on a miss). The split
    kernel's epsilon and ties: the second triangle wins an equal t.

    Where XLA's CPU compiler fuses a multiply into the add or subtract that
    consumes it, this rounds once too (``_fma``): x y - z w as
    fma(x, y, -(z w)) and a sum of three products as fma(c, c', fma(a, a',
    b b')), so t equals the reference's bit for bit."""
    w = [i2f(pt[i]) for i in range(12)]

    def dif(a, b, c, d):
        return _fma(a, b, -(c * d))

    def sum3(a0, b0, a1, b1, a2, b2):
        return _fma(a2, b2, _fma(a0, b0, a1 * b1))

    def mt(ax_, ay_, az_, bx, by, bz, cx, cy, cz):
        e1x, e1y, e1z = bx - ax_, by - ay_, bz - az_
        e2x, e2y, e2z = cx - ax_, cy - ay_, cz - az_
        hx, hy, hz = dif(dy, e2z, dz, e2y), dif(dz, e2x, dx, e2z), dif(dx, e2y, dy, e2x)
        det = sum3(e1x, hx, e1y, hy, e1z, hz)
        degen = (det > -_TRI_EPS) & (det < _TRI_EPS)
        f = 1.0 / det
        sx, sy, sz = ox - ax_, oy - ay_, oz - az_
        u = f * sum3(sx, hx, sy, hy, sz, hz)
        qx, qy, qz = dif(sy, e1z, sz, e1y), dif(sz, e1x, sx, e1z), dif(sx, e1y, sy, e1x)
        v = f * sum3(dx, qx, dy, qy, dz, qz)
        t = f * sum3(e2x, qx, e2y, qy, e2z, qz)
        acc = (~degen & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin)
               & (t <= tmax))
        return torch.where(acc, t, _F32_MAX)

    ta = mt(*w[0:3], *w[3:6], *w[6:9])
    tb = mt(*w[6:9], *w[3:6], *w[9:12])
    second = tb <= ta
    t = torch.minimum(ta, tb)
    enc = torch.where(t < _F32_MAX, second.to(torch.int32), -1)
    return t, enc


def _cell_at(o_a, d_a, t, gmin_a, cs_a, g_a: int) -> torch.Tensor:
    """``clip(floor((o + d t - gmin) / cs).astype(int32), 0, g - 1)`` with
    XLA's saturating conversion: clamp in float, then truncate."""
    x = torch.nan_to_num(torch.floor((o_a + d_a * t - gmin_a) / cs_a), nan=0.0)
    return x.clamp(0.0, float(g_a - 1)).to(torch.int32)


def _tmax_at(c_a, st_a, o_a, inv_a, gmin_a, cs_a):
    bound = gmin_a + (c_a + (st_a > 0).to(torch.int32)).to(torch.float32) * cs_a
    return torch.where(st_a != 0, (bound - o_a) * inv_a, _F32_MAX)


def _run_dda(grid: UniformGrid, rows: torch.Tensor, ctx: dict, st: dict, max_iter: int,
             any_hit: bool, block: int) -> None:
    """The DDA walk over state ``st`` (updated in place) with per-ray
    invariants ``ctx``, for at most ``max_iter`` iterations; each iteration
    runs over the rays not yet done."""
    gx, gy, gz = grid.res
    num_rows = rows.shape[0]
    num_refs = grid.refs.shape[0]
    gmin, cs = grid.grid_min, grid.cell_size
    it = 0
    while it < max_iter:
        r = torch.nonzero(~st["done"]).reshape(-1)
        if r.numel() == 0:
            break
        it += 1
        c = {k: ctx[k][r] for k in _CTX}
        s = {k: st[k][r] for k in _STATE}
        cid = ((s["cz"] * gy + s["cy"]) * gx + s["cx"]).to(torch.int64)
        start = grid.cell_start[cid]
        word = grid.cell_word[cid]
        count = word & ((1 << DIST_SHIFT) - 1)
        dist = word >> DIST_SHIFT
        off = s["off"]
        rem = count - off
        bt, btr, tt = s["bt"], s["btr"], s["tt"]
        for j in range(block):
            live_j = j < rem
            ridx = grid.refs[(start + off + j).clamp(0, num_refs - 1).to(torch.int64)]
            ridx = ridx.clamp(max=num_rows - 1)
            pt = rows[ridx.to(torch.int64), :12].T
            t, enc = _mt_cols(pt, c["ox"], c["oy"], c["oz"], c["dx"], c["dy"], c["dz"],
                              c["tmin"], bt)
            upd = live_j & (enc >= 0) & (t < bt)
            bt = torch.where(upd, t, bt)
            btr = torch.where(upd, (ridx << 1) | enc, btr)
            tt = tt + 2 * live_j.to(torch.int32)

        tmx, tmy, tmz = s["tmx"], s["tmy"], s["tmz"]
        drained = rem <= block
        texit = torch.minimum(torch.minimum(tmx, tmy), tmz)
        if any_hit:
            finished = btr >= 0  # occlusion needs no drain
        else:
            finished = drained & (bt <= texit)  # front to back: final

        # one fine DDA step for drained, unfinished rays
        stepping = drained & ~finished
        ax_x = (tmx <= tmy) & (tmx <= tmz)
        ax_y = ~ax_x & (tmy <= tmz)
        ax_z = ~ax_x & ~ax_y
        zero = torch.zeros_like(s["cx"])
        cx_n = s["cx"] + torch.where(stepping & ax_x, c["stx"], zero)
        cy_n = s["cy"] + torch.where(stepping & ax_y, c["sty"], zero)
        cz_n = s["cz"] + torch.where(stepping & ax_z, c["stz"], zero)
        tmx_n = torch.where(stepping & ax_x, tmx + c["tdx"], tmx)
        tmy_n = torch.where(stepping & ax_y, tmy + c["tdy"], tmy)
        tmz_n = torch.where(stepping & ax_z, tmz + c["tdz"], tmz)
        oob = ((cx_n < 0) | (cx_n >= gx) | (cy_n < 0) | (cy_n >= gy) | (cz_n < 0)
               | (cz_n >= gz) | (texit > s["tfar"]))
        done_n = finished | (stepping & oob)
        off_n = torch.where(drained, 0, off + block)

        # the distance-field skip: from an empty cell with dist D >= 2, land
        # just before the (D-1)-th boundary crossing on any axis
        skip = dist >= 2
        dd = (dist - 1).to(torch.float32)
        t_land = torch.minimum(torch.minimum(tmx + dd * c["tdx"], tmy + dd * c["tdy"]),
                               tmz + dd * c["tdz"]) - c["nudge"]
        cx_l = _cell_at(c["ox"], c["dx"], t_land, gmin[0], cs[0], gx)
        cy_l = _cell_at(c["oy"], c["dy"], t_land, gmin[1], cs[1], gy)
        cz_l = _cell_at(c["oz"], c["dz"], t_land, gmin[2], cs[2], gz)
        done_s = t_land > s["tfar"]
        if not any_hit:
            done_s = done_s | (bt <= t_land)
        tmx_l = _tmax_at(cx_l, c["stx"], c["ox"], c["invx"], gmin[0], cs[0])
        tmy_l = _tmax_at(cy_l, c["sty"], c["oy"], c["invy"], gmin[1], cs[1])
        tmz_l = _tmax_at(cz_l, c["stz"], c["oz"], c["invz"], gmin[2], cs[2])

        st["cx"][r] = torch.where(skip, cx_l, cx_n)
        st["cy"][r] = torch.where(skip, cy_l, cy_n)
        st["cz"][r] = torch.where(skip, cz_l, cz_n)
        st["tmx"][r] = torch.where(skip, tmx_l, tmx_n)
        st["tmy"][r] = torch.where(skip, tmy_l, tmy_n)
        st["tmz"][r] = torch.where(skip, tmz_l, tmz_n)
        st["done"][r] = torch.where(skip, done_s, done_n)
        st["off"][r] = torch.where(skip, 0, off_n)
        st["bt"][r], st["btr"][r], st["tt"][r] = bt, btr, tt
        st["steps"][r] = s["steps"] + 1


def trace_rays_grid(grid: UniformGrid, pairs: PackedPairs, rays: Rays, active=None,
                    any_hit: bool = False, block: int = 4, segments: int = 1,
                    residue_after: int = 0,
                    residue_width: int = 0) -> Tuple[HitRecord, TraceStats]:
    """Closest-hit (or any-hit) trace of a ray batch through the grid.
    Returns (HitRecord, TraceStats); the grid keeps no stack, so
    ``overflow`` is always 0.

    ``segments`` > 1 traces that many equal ray slices one after another;
    ``residue_after`` > 0 runs that many iterations over every ray, then
    the rays still walking, in ray order, in chunks of ``residue_width``
    (0: max(4096, R / 8), rounded up to a multiple of 1024) each run to
    completion. Both give the single-phase result bit for bit."""
    num = rays.origin.shape[0]
    dev = rays.origin.device
    if segments > 1:
        if num % segments:
            raise ValueError(f"{num} rays do not split into {segments} segments")
        act = torch.ones((num,), dtype=torch.bool, device=dev) if active is None else active
        n = num // segments
        recs, stats = [], []
        for i in range(segments):
            sl = slice(i * n, (i + 1) * n)
            r, s = trace_rays_grid(grid, pairs, Rays(rays.origin[sl], rays.direction[sl],
                                                     rays.tmin[sl], rays.tmax[sl]),
                                   active=act[sl], any_hit=any_hit, block=block,
                                   residue_after=residue_after, residue_width=residue_width)
            recs.append(r)
            stats.append(s)
        cat = lambda f, xs: torch.cat([getattr(x, f) for x in xs])  # noqa: E731
        return (HitRecord(*(cat(f, recs) for f in ("hit", "t", "prim_id", "tri_id", "bary_u",
                                                   "bary_v"))),
                TraceStats(box_tests=cat("box_tests", stats), tri_tests=cat("tri_tests", stats),
                           overflow=sum(s.overflow for s in stats)))

    gx, gy, gz = grid.res
    rows = pairs.rows
    if active is None:
        active = torch.ones((num,), dtype=torch.bool, device=dev)
    ox, oy, oz = rays.origin.unbind(dim=1)
    dx, dy, dz = rays.direction.unbind(dim=1)
    tmin = rays.tmin

    def safe(a):
        return torch.where(a.abs() < 1e-20, 1e-20, a)

    invx, invy, invz = 1.0 / safe(dx), 1.0 / safe(dy), 1.0 / safe(dz)
    gmin, gmax, cs = grid.grid_min, grid.grid_max, grid.cell_size

    best_t = rays.tmax.clone()
    best_tri = torch.full((num,), -1, dtype=torch.int32, device=dev)
    tri_tests = torch.zeros((num,), dtype=torch.int32, device=dev)

    # the big list: oversized rows, tested once by every ray
    nbig = int(grid.num_big)
    for i in range(min(nbig, grid.big.shape[0])):
        ridx = grid.big[i]
        pt = rows[ridx, :12].reshape(12, 1).expand(12, num)
        t, enc = _mt_cols(pt, ox, oy, oz, dx, dy, dz, tmin, best_t)
        upd = active & (enc >= 0) & (t < best_t)
        best_t = torch.where(upd, t, best_t)
        best_tri = torch.where(upd, (ridx << 1) | enc, best_tri)
        tri_tests = tri_tests + 2 * active.to(torch.int32)

    # DDA set-up: the box's slabs and the first cell
    def slab(o_a, inv_a, gmin_a, gmax_a):
        t0 = (gmin_a - o_a) * inv_a
        t1 = (gmax_a - o_a) * inv_a
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    nx0, fx0 = slab(ox, invx, gmin[0], gmax[0])
    ny0, fy0 = slab(oy, invy, gmin[1], gmax[1])
    nz0, fz0 = slab(oz, invz, gmin[2], gmax[2])
    tnear = torch.maximum(torch.maximum(nx0, ny0), nz0)
    # no acceptable hit lies past the ray's own tmax: stop marching there
    tfar = torch.minimum(torch.minimum(torch.minimum(fx0, fy0), fz0), rays.tmax)
    miss_box = (tnear > tfar) | (tfar < tmin) | (tnear > rays.tmax)
    start_t = torch.clamp(torch.maximum(tnear, tmin), min=0.0)

    cx = _cell_at(ox, dx, start_t, gmin[0], cs[0], gx)
    cy = _cell_at(oy, dy, start_t, gmin[1], cs[1], gy)
    cz = _cell_at(oz, dz, start_t, gmin[2], cs[2], gz)
    stx, sty, stz = (torch.where(a > 0, 1, torch.where(a < 0, -1, 0)).to(torch.int32)
                     for a in (dx, dy, dz))
    tdx = torch.where(stx != 0, cs[0] * invx.abs(), _F32_MAX)
    tdy = torch.where(sty != 0, cs[1] * invy.abs(), _F32_MAX)
    tdz = torch.where(stz != 0, cs[2] * invz.abs(), _F32_MAX)

    done = ~active | miss_box
    if any_hit:
        done = done | (best_tri >= 0)
    # the skip's backward margin: ~1e-3 of a cell along the dominant axis
    dmax = torch.maximum(torch.maximum(dx.abs(), dy.abs()), dz.abs())
    nudge = 1e-3 * torch.minimum(torch.minimum(cs[0], cs[1]), cs[2]) / torch.clamp(dmax,
                                                                                   min=1e-20)
    ctx = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, invx=invx, invy=invy, invz=invz,
               stx=stx, sty=sty, stz=stz, tdx=tdx, tdy=tdy, tdz=tdz, tmin=tmin, nudge=nudge)
    st = dict(cx=cx, cy=cy, cz=cz,
              tmx=_tmax_at(cx, stx, ox, invx, gmin[0], cs[0]),
              tmy=_tmax_at(cy, sty, oy, invy, gmin[1], cs[1]),
              tmz=_tmax_at(cz, stz, oz, invz, gmin[2], cs[2]),
              off=torch.zeros((num,), dtype=torch.int32, device=dev), done=done, bt=best_t,
              btr=best_tri, tt=tri_tests,
              steps=torch.zeros((num,), dtype=torch.int32, device=dev), tfar=tfar)
    iter_cap = 8 * max(gx, gy, gz) + (1 << 17)

    if residue_after <= 0:
        _run_dda(grid, rows, ctx, st, iter_cap, any_hit, block)
    else:
        _run_dda(grid, rows, ctx, st, residue_after, any_hit, block)
        order = torch.nonzero(~st["done"]).reshape(-1)  # the survivors, in ray order
        w2 = residue_width if residue_width > 0 else max(4096, -(-num // 8))
        w2 = min(-(-w2 // 1024) * 1024, num)
        for s0 in range(0, order.numel(), w2):
            idx = order[s0:s0 + w2]
            ctx2 = {k: v[idx] for k, v in ctx.items()}
            st2 = {k: v[idx] for k, v in st.items()}
            _run_dda(grid, rows, ctx2, st2, iter_cap, any_hit, block)
            for k in ("bt", "btr", "tt", "steps", "done"):
                st[k][idx] = st2[k]

    rec = reconstruct(pairs, rays, st["bt"], st["btr"])
    if any_hit:
        rec.t = torch.where(rec.hit, st["bt"], rays.tmax)
    return rec, TraceStats(box_tests=st["steps"], tri_tests=st["tt"],
                           overflow=torch.zeros((1,), dtype=torch.int32, device=dev))


def make_grid_tracer(any_hit: bool = False, block: int = 4, segments: int = 1,
                     residue_after: int = 0, residue_width: int = 0):
    """Tracer ``(grid, pairs, rays, active=None) ->
    (HitRecord, TraceStats)`` with the render pipeline's signature: the
    structure argument is the UniformGrid."""
    def tracer(grid, pairs, rays, active=None):
        return trace_rays_grid(grid, pairs, rays, active=active, any_hit=any_hit, block=block,
                               segments=segments, residue_after=residue_after,
                               residue_width=residue_width)
    return tracer
