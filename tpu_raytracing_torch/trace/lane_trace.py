"""Per-ray treelet traversal: the K5 kernel's wrapper, its plain version,
the drivers and the tracer front end.

Port of ``tpu_raytracing/trace/lane_pallas.py`` (``STACK``, ``RECOVER``,
``SROWS``, ``init_state``, ``trace_rays_lane_pallas`` ->
``trace_rays_lane``, ``_warn_unfinished`` -> ``_unfinished``,
``trace_rays_lane_restart``, ``trace_rays_lane_wave``,
``trace_rays_lane_phase`` and ``make_lane_tracer``). The Pallas kernel
``_lane_kernel`` becomes the CUDA kernel ``csrc/lane_trace.cu``;
``lane_traverse`` is its wrapper. Given CPU tensors it runs
``trace_lane_plain``, the same per-ray machine vectorised over rays in
PyTorch; given CUDA tensors it launches the kernel or raises. The two agree
bit for bit on every out row and state row.

Layouts are the reference's. ``tables`` [T, wh, ecap] f32 (ecap <= 128),
which the plain version reads; the kernel reads ``columns`` [T, ecap, wh],
the same words column-contiguous (``TreeletBVH.columns``); ``rays8``
[num_p, 8, 128] f32 (o, d, tmin, tmax; dead rays have tmin = +F32_MAX,
tmax = -F32_MAX); ``state`` [num_p, 5 + stack, 128] i32 (rows:
0 current entry, 1 tbest bits, 2 tribest, 3 stack depth, 4 depth
watermark, 5.. the stack, top first); out [num_p, 8, 128] f32 (rows: 0 t,
1 tri bits, 2 box tests, 3 tri tests, 4 iterations, 5 treelet switches,
6 watermark, 7 wanted tid + 1, or 0 for a finished ray). An entry word is
``tid << 9 | col << 2 | typ`` (typ 1 inner column, 2 window column, 0
none); a portal entry becomes its child treelet's root entry when pushed.

Budgets are per ray, not per packet. On the TPU a 128-lane packet shares
one resident treelet table, and its iteration budget and ``no_switch`` rule
drain the whole packet. Here every ray reads the tables from device memory
on its own, so:

* ``budget > 0``: a ray stops after ``budget`` iterations of its own;
* ``no_switch``: a ray stops when its current entry's treelet differs from
  the one it started the launch in;
* a stopped ray exports its full state, and out row 7 holds its live
  entry's tid + 1; rows 4 and 5 count the ray's own iterations and
  treelet changes.

So after budgeted or ``no_switch`` launches the state, row 7 and rows 4-5
are not comparable with the TPU kernel's; after every driver the final
``(t, tri)`` are, and so are rows 0-3 of an unbudgeted launch with no
overflow. A ray also stops after ``_MAX_ITERS`` iterations in one launch,
a guard against a corrupt table that the drivers report as unfinished.

Knobs: the reference reads the budgets, the driver and the stack depth
from ``TPURT_LANE_*`` environment variables; here they are arguments with
the reference's defaults. ``C`` (packet slots in flight), ``CHUNK``
(iterations between scheduler checks) and ``SKIP`` (per-packet phase
gating) schedule 128-lane packets on the TPU and have no per-ray
counterpart, so they are not ported. A ray still unfinished after the
recovery rounds sets ``TraceStats.overflow``, and ``path_trace`` raises
on it; the reference only warns there.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from tpu_raytracing_torch.bvh.treelet import TreeletBVH
from tpu_raytracing_torch.ops import _cuda_build
from tpu_raytracing_torch.ops.intersect import safe_inverse
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.split_trace import _map
from tpu_raytracing_torch.trace.traverse import PackedPairs, TraceStats, f2i, i2f, reconstruct

# Per-ray stack depth. A ray whose depth watermark passes STACK - 8 may
# have dropped far entries (pushes past STACK drop the deepest ones); it is
# flagged wanting its root (out row 7) and the drivers re-run it.
STACK = 32
# Extra unbudgeted rounds after the last one, for flagged rays.
RECOVER = 2
SROWS = 5 + STACK
# Widest treelet table (the column field of an entry word has 7 bits),
# widest leaf window (2 * 128 triangles, 8 a lane) and deepest stack the
# kernel takes.
MAX_ECAP = 128
MAX_LEAFW = 128
MAX_STACK = 128
# Iterations one ray may take in one launch (a guard, far above any tree).
_MAX_ITERS = 1 << 20
_F32_MAX = float(torch.finfo(torch.float32).max)
_TRI_EPS = 1e-9
_BIG = 2 ** 30
_NONE = 0  # entry word: dead / empty stack slot

# K5 launches since the count was last set to 0: lane_traverse adds one
# where it launches the kernel and nowhere else.
launch_count = 0


def init_state(root_tid: int, tmax, active=None, stack: int = STACK):
    """Fresh state [num_p, 5 + stack, 128] for a trace from the root: cur =
    root entry (NONE for inactive rays), tbest = tmax (-F32_MAX inactive),
    tribest = -1, empty stack."""
    num = tmax.shape[0]
    num_p = num // 128
    dev = tmax.device
    e0 = torch.full((num,), (int(root_tid) << 9) | 1, dtype=torch.int32, device=dev)
    if active is not None:
        e0 = torch.where(active, e0, _NONE)
        tmax = torch.where(active, tmax, -_F32_MAX)
    rows = [e0.reshape(num_p, 1, 128), f2i(tmax).reshape(num_p, 1, 128),
            torch.full((num_p, 1, 128), -1, dtype=torch.int32, device=dev),
            torch.zeros((num_p, 2 + stack, 128), dtype=torch.int32, device=dev)]
    return torch.cat(rows, dim=1)


def pad_to_packets(rays: Rays, active=None):
    """Rays padded to a multiple of 128 by repeating the last ray, dead;
    returns (rays, active)."""
    num = rays.origin.shape[0]
    pad = (-num) % 128
    if not pad:
        return rays, active
    dev = rays.origin.device
    idx = torch.cat([torch.arange(num, device=dev), torch.full((pad,), num - 1, device=dev)])
    act = torch.ones((num,), dtype=torch.bool, device=dev) if active is None else active
    return rays.take(idx), torch.cat([act, torch.zeros((pad,), dtype=torch.bool, device=dev)])


def rays8_of(rays: Rays, active=None):
    """[num_p, 8, 128] f32 ray block; dead rays get an empty interval."""
    num = rays.origin.shape[0]
    tmin, tmax = rays.tmin, rays.tmax
    if active is not None:
        tmin = torch.where(active, tmin, _F32_MAX)
        tmax = torch.where(active, tmax, -_F32_MAX)
    cols = torch.cat([rays.origin, rays.direction, tmin[:, None], tmax[:, None]], dim=1)
    return cols.to(torch.float32).reshape(num // 128, 128, 8).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# The plain version


def _per_ray(block):
    """[num_p, rows, 128] -> [num, rows]."""
    num_p, rows, _ = block.shape
    return block.transpose(1, 2).reshape(num_p * 128, rows)


def _per_packet(cols):
    """[num, rows] -> [num_p, rows, 128]."""
    num, rows = cols.shape
    return cols.reshape(num // 128, 128, rows).transpose(1, 2).contiguous()


def _moller_trumbore(a, b, c, o, d):
    """Möller-Trumbore over [R, lw] vertex components in the kernel's
    operation order; returns (t, accepted)."""
    (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = a, b, c
    ox, oy, oz = o
    dx, dy, dz = d
    e1x, e1y, e1z = b0 - a0, b1 - a1, b2 - a2
    e2x, e2y, e2z = c0 - a0, c1 - a1, c2 - a2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(det.abs() < _TRI_EPS, _TRI_EPS, det)
    sx, sy, sz = ox - a0, oy - a1, oz - a2
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (det.abs() >= _TRI_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, ok


def _window_visit(flat, base, col_stride, lw, o, d, tmn, tb1, tribest):
    """Window columns for rays at them: returns (tbest, tribest)."""
    dev = base.device
    rows = torch.arange(12 * lw + 1, dtype=torch.int64, device=dev)
    g = flat[base[:, None] + rows[None, :] * col_stride]
    gv = g[:, :12 * lw].reshape(-1, 12, lw)
    gstart = f2i(g[:, 12 * lw])
    v = [gv[:, w] for w in range(12)]
    oc = tuple(o[:, i:i + 1] for i in range(3))
    dc = tuple(d[:, i:i + 1] for i in range(3))
    ta, oka = _moller_trumbore(v[0:3], v[3:6], v[6:9], oc, dc)
    tb, okb = _moller_trumbore(v[6:9], v[3:6], v[9:12], oc, dc)
    tmn_c, tb1_c = tmn[:, None], tb1[:, None]
    tva = torch.where(oka & (ta >= tmn_c) & (ta <= tb1_c), ta, _F32_MAX)
    tvb = torch.where(okb & (tb >= tmn_c) & (tb <= tb1_c), tb, _F32_MAX)
    wmin = torch.minimum(tva.amin(dim=1), tvb.amin(dim=1))
    whit = wmin <= tb1
    slot = torch.arange(lw, dtype=torch.int32, device=dev)[None, :]
    # winner: the largest p*2+second among t == wmin (later slot and the
    # second triangle win ties)
    ia = torch.where(tva == wmin[:, None], slot * 2, -1)
    ib = torch.where(tvb == wmin[:, None], slot * 2 + 1, -1)
    widx = torch.maximum(ia.amax(dim=1), ib.amax(dim=1))
    return torch.where(whit, wmin, tb1), torch.where(whit, gstart * 2 + widx, tribest)


def _inner_visit(flat, base, col_stride, etid, o, inv, tmn, tbest):
    """Inner columns for rays at them: returns (k hits, pushvals [R, 8]),
    pushvals[q] the entry word of the rank-q hit (nearest first, the
    higher entry id on a tie)."""
    dev = base.device
    rows = torch.arange(56, dtype=torch.int64, device=dev)
    g = flat[base[:, None] + rows[None, :] * col_stride]
    gb = g[:, :48].reshape(-1, 6, 8)
    t0 = (gb[:, 0:3] - o[:, :, None]) * inv[:, :, None]
    t1 = (gb[:, 3:6] - o[:, :, None]) * inv[:, :, None]
    tn = torch.minimum(t0, t1).amax(dim=1)
    tf = torch.maximum(t0, t1).amin(dim=1)
    tn = torch.maximum(tn, tmn[:, None])
    tf = torch.minimum(tf, tbest[:, None])
    m = f2i(g[:, 48:56])
    mtyp = m & 7
    hit = (tf >= tn) & (mtyp != 0)
    key = torch.where(hit, tn, _F32_MAX)
    e_ids = torch.arange(8, device=dev)
    ka, kb = key[:, :, None], key[:, None, :]
    closer = (kb < ka) | ((kb == ka) & (e_ids[None, None, :] > e_ids[None, :, None]))
    rank = (closer & hit[:, None, :]).sum(dim=2)
    k = hit.sum(dim=1)
    child = m >> 5
    ev = torch.where(mtyp == 3, (child << 9) | 1,
                     (etid[:, None] << 9) | (child << 2) | torch.where(mtyp == 2, 2, 1))
    eq = (rank[:, None, :] == e_ids[None, :, None]) & hit[:, None, :]
    pushvals = torch.where(eq, ev[:, None, :], 0).sum(dim=2).to(torch.int32)
    return k, pushvals


def trace_lane_plain(tables, rays8, state, root_tid: int, *, lw: int, any_hit: bool,
                     budget: int = 0, no_switch: bool = False, visited=None):
    """K5's plain PyTorch version: every running ray advances one element
    per iteration, with table gathers indexed by (tid, row, col), and a
    bottom-first [R, stack] stack per ray. Returns (out [num_p, 8, 128] f32,
    state_out [num_p, 5 + stack, 128] i32); see the module docstring. With
    ``visited`` (a dict), also marks the ``inner`` and ``window`` columns
    [T * ecap] (tid * ecap + col) that any ray read."""
    num_p, srows, _ = state.shape
    stack = srows - 5
    num = num_p * 128
    dev = rays8.device
    _, wh, ecap = tables.shape
    flat = tables.reshape(-1)
    r = _per_ray(rays8)
    o, d, tmn = r[:, 0:3], r[:, 3:6], r[:, 6]
    inv = safe_inverse(d)
    s = _per_ray(state)
    cur = s[:, 0].clone()
    tbest = i2f(s[:, 1].clone())
    tribest = s[:, 2].clone()
    depth = s[:, 3].clone()
    wmark = s[:, 4].clone()
    # the state's stack is top first and top-contiguous; keep it bottom first
    top_first = s[:, 5:]
    n = torch.cumprod((top_first != _NONE).to(torch.int64), dim=1).sum(dim=1)
    j = torch.arange(stack, dtype=torch.int64, device=dev)[None, :]
    stk = torch.where(j < n[:, None],
                      top_first.gather(1, torch.clamp(n[:, None] - 1 - j, min=0)), _NONE)
    zeros = lambda: torch.zeros((num,), dtype=torch.int32, device=dev)  # noqa: E731
    box, tri, iters, switches = zeros(), zeros(), zeros(), zeros()
    start_tid = cur >> 9
    res = start_tid.clone()
    limit = budget if budget > 0 else _MAX_ITERS
    if visited is not None:
        for key in ("inner", "window"):
            visited[key] = torch.zeros((tables.shape[0] * ecap,), dtype=torch.bool, device=dev)

    while True:
        run = (cur != _NONE) & (iters < limit)
        if no_switch:
            run &= (cur >> 9) == start_tid
        ids = torch.nonzero(run).reshape(-1)
        if ids.numel() == 0:
            break
        c = cur[ids]
        etid = c >> 9
        typ = c & 3
        col = (c >> 2) & 127
        switches[ids] += (etid != res[ids]).to(torch.int32)
        res[ids] = etid
        iters[ids] += 1
        base = (etid.to(torch.int64) * wh) * ecap + col.to(torch.int64)
        k1 = torch.zeros_like(ids)
        pv = torch.zeros((ids.shape[0], 8), dtype=torch.int32, device=dev)

        if visited is not None:
            col_ids = etid.to(torch.int64) * ecap + col.to(torch.int64)
            visited["window"][col_ids[typ == 2]] = True
            visited["inner"][col_ids[typ == 1]] = True
        wsel = typ == 2
        if bool(wsel.any()):
            wi = ids[wsel]
            tbest[wi], tribest[wi] = _window_visit(flat, base[wsel], ecap, lw, o[wi], d[wi],
                                                   tmn[wi], tbest[wi], tribest[wi])
            tri[wi] += 2 * lw
        isel = typ == 1
        if bool(isel.any()):
            ii = ids[isel]
            k1[isel], pv[isel] = _inner_visit(flat, base[isel], ecap, etid[isel], o[ii], inv[ii],
                                              tmn[ii], tbest[ii])
            box[ii] += 8

        # stack update: push the hits (nearest becomes cur) or pop
        if any_hit:
            found = tribest[ids] >= 0
            k1 = torch.where(found, 0, k1)
        push = k1 > 0
        for q in range(7, 0, -1):
            sel = push & (k1 > q)
            if bool(sel.any()):
                rows = ids[sel]
                full = n[rows] == stack
                if bool(full.any()):  # drop the deepest entry
                    fr = rows[full]
                    stk[fr] = torch.cat([stk[fr, 1:], torch.zeros_like(stk[fr, :1])], dim=1)
                    n[fr] -= 1
                stk[rows, n[rows]] = pv[sel, q]
                n[rows] += 1
        pop = ids[~push]
        has = n[pop] > 0
        top = stk[pop, torch.clamp(n[pop] - 1, min=0)]
        new_cur = torch.where(push, pv[:, 0], 0)
        new_cur[~push] = torch.where(has, top, _NONE)
        n[pop] = torch.clamp(n[pop] - 1, min=0)
        delta = torch.where(push, k1 - 1, -1).to(torch.int32)
        new_depth = torch.clamp(depth[ids] + delta, min=0)
        if any_hit:
            new_cur = torch.where(found, _NONE, new_cur)
            new_depth = torch.where(found, 0, new_depth)
            n[ids[found]] = 0
        cur[ids] = new_cur.to(torch.int32)
        depth[ids] = new_depth
        wmark[ids] = torch.maximum(wmark[ids], new_depth)

    top = torch.where(n > 0, stk.gather(1, torch.clamp(n - 1, min=0)[:, None])[:, 0], _NONE)
    live = (cur != _NONE) | (top != _NONE)
    ovf = wmark > stack - 8
    live_e = torch.where((cur & 3) != 0, cur, top)
    wtid = torch.where(live, live_e >> 9, int(root_tid))
    want = torch.where(live | ovf, wtid + 1, 0)
    out = torch.stack([tbest, i2f(tribest), box.float(), tri.float(), iters.float(),
                       switches.float(), wmark.float(), want.float()], dim=1)
    top_first_out = torch.where(j < n[:, None],
                                stk.gather(1, torch.clamp(n[:, None] - 1 - j, min=0)), _NONE)
    state_out = torch.cat([cur[:, None], f2i(tbest)[:, None], tribest[:, None], depth[:, None],
                           wmark[:, None], top_first_out.to(torch.int32)], dim=1)
    return _per_packet(out), _per_packet(state_out)


# ---------------------------------------------------------------------------
# The kernel's wrapper

_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _check_operands(tables, columns, rays8, state, lw: int) -> None:
    dev = rays8.device
    for name, x, dtype, ndim in (("tables", tables, torch.float32, 3),
                                 ("columns", columns, torch.float32, 3),
                                 ("rays8", rays8, torch.float32, 3),
                                 ("state", state, torch.int32, 3)):
        if x.device != dev or x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
            raise ValueError(
                f"lane_traverse: {name} must be a contiguous {ndim}-d {dtype} tensor on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    num_p = rays8.shape[0]
    t, wh, ecap = tables.shape
    if columns.shape != (t, ecap, wh) or wh % 4 or columns.data_ptr() % 16:
        raise ValueError(f"lane_traverse: columns {tuple(columns.shape)} are not the 16-byte "
                         f"aligned [T, ecap, wh] of tables {tuple(tables.shape)} (wh % 4 == 0)")
    if rays8.shape != (num_p, 8, 128) or state.shape[0] != num_p or state.shape[2] != 128:
        raise ValueError(f"lane_traverse: rays8 {tuple(rays8.shape)} and state "
                         f"{tuple(state.shape)} are not [num_p, 8 | 5 + stack, 128]")
    if not 1 <= state.shape[1] - 5 <= MAX_STACK:
        raise ValueError(f"lane_traverse: stack depth {state.shape[1] - 5} outside "
                         f"[1, {MAX_STACK}]")
    if not 1 <= ecap <= MAX_ECAP or wh < max(56, 12 * lw + 1) or not 1 <= lw <= MAX_LEAFW:
        raise ValueError(f"lane_traverse: tables [T, {wh}, {ecap}] do not hold leaf width {lw}")


def lane_traverse(tables, columns, rays8, state, root_tid: int, *, lw: int, any_hit: bool,
                  budget: int = 0, no_switch: bool = False):
    """K5: resume every ray's treelet traversal from ``state`` (see the
    module docstring). ``tables`` and ``columns`` are a TreeletBVH's two
    layouts of the same words. Returns (out, state_out).

    CPU tensors run ``trace_lane_plain`` on ``tables``; CUDA tensors launch
    the kernel on ``columns`` or raise.
    """
    global launch_count
    if rays8.device.type == "cpu":
        return trace_lane_plain(tables, rays8, state, root_tid, lw=lw, any_hit=any_hit,
                                budget=budget, no_switch=no_switch)
    if rays8.device.type != "cuda":
        raise ValueError(f"lane_traverse: unsupported device {rays8.device}")
    _check_operands(tables, columns, rays8, state, lw)
    lib = _cuda_build.load_library("lane_trace")
    fn = lib.lane_trace_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    num_p = rays8.shape[0]
    out = torch.empty((num_p, 8, 128), dtype=torch.float32, device=rays8.device)
    state_out = torch.empty_like(state)
    if num_p == 0:
        return out, state_out
    t, wh, ecap = tables.shape
    stream = torch.cuda.current_stream(rays8.device).cuda_stream
    err = fn(columns.data_ptr(), t, wh, ecap, lw, rays8.data_ptr(), state.data_ptr(),
             out.data_ptr(), state_out.data_ptr(), num_p, int(root_tid), state.shape[1] - 5,
             int(budget), int(no_switch), int(any_hit), stream)
    if err != 0:
        raise RuntimeError(f"lane_trace kernel launch failed: cudaError {err}")
    launch_count += 1
    return out, state_out


# ---------------------------------------------------------------------------
# Tracer and drivers


def _unfinished(want):
    """[1] int32 overflow flag: nonzero when a ray still wants work after
    the last round (it would silently lose hits)."""
    return (want > 0).any().to(torch.int32).reshape(1)


def trace_rays_lane(tb: TreeletBVH, packed: PackedPairs, rays: Rays, active=None,
                    any_hit: bool = False, raw: bool = False, budget: int = 0, state=None,
                    no_switch: bool = False, stack: int = STACK):
    """One K5 launch over a ray count that is a multiple of 128.

    ``state`` resumes a suspended trace (default: fresh from the root).
    Returns (HitRecord, TraceStats), or with ``raw`` ((t, tri), stats,
    out, state_out). ``stats.overflow`` is set if any ray is unfinished.
    """
    num = rays.origin.shape[0]
    if num % 128:
        raise ValueError(f"trace_rays_lane: {num} rays is not a multiple of 128")
    if state is None:
        state = init_state(tb.root_tid, rays.tmax, active, stack)
    out, state_out = lane_traverse(tb.tables, tb.columns, rays8_of(rays, active), state,
                                   int(tb.root_tid), lw=tb.leaf_width, any_hit=any_hit,
                                   budget=budget, no_switch=no_switch)
    t = out[:, 0, :].reshape(num)
    tri = f2i(out[:, 1, :]).reshape(num)
    want = out[:, 7, :].reshape(num)
    stats = TraceStats(box_tests=out[:, 2, :].reshape(num).to(torch.int32),
                       tri_tests=out[:, 3, :].reshape(num).to(torch.int32),
                       overflow=_unfinished(want))
    if any_hit:
        t = rays.tmax
    if raw:
        return (t, tri), stats, out, state_out
    return reconstruct(packed, rays, t, tri, any_hit=any_hit), stats


def _finish(packed, rays, t, tri, box, trit, want, any_hit, raw):
    stats = TraceStats(box_tests=box, tri_tests=trit, overflow=_unfinished(want))
    if any_hit:
        t = rays.tmax
    if raw:
        return (t, tri), stats, want
    return reconstruct(packed, rays, t, tri, any_hit=any_hit), stats


def trace_rays_lane_restart(tb: TreeletBVH, packed: PackedPairs, rays: Rays, active=None,
                            any_hit: bool = False, raw: bool = False,
                            budgets: Optional[Sequence[int]] = None, stack: int = STACK):
    """Budget-restart driver: round 0 runs under ``budgets[0]``; rays cut
    off restart from the root in later rounds, sorted by wanted treelet,
    with tmax tightened to their partial t (a tighter interval visits a
    subset of the remaining work, and the carried hit stands unless a new
    one beats it). The last rounds run unbudgeted; ``RECOVER`` extra rounds
    re-run rays flagged for stack overflow.

    An any-hit ray that has found an occluder is finished even if its stack
    watermark flagged it: the hit stands whatever was dropped. (The
    reference restarts it, finds the same occluder with the same watermark,
    and warns after the last round.)"""
    budgets = (128,) if budgets is None else tuple(budgets)
    num = rays.origin.shape[0]

    def wanted(out, tri):
        want = out[:, 7, :].to(torch.int32).reshape(num)
        return torch.where(tri >= 0, 0, want) if any_hit else want

    (t, tri), stats, out, _ = trace_rays_lane(
        tb, packed, rays, active=active, any_hit=any_hit, raw=True,
        budget=budgets[0] if budgets else 0, stack=stack)
    want = wanted(out, tri)
    box, trit = stats.box_tests, stats.tri_tests
    for b in list(budgets[1:]) + [0] * (1 + RECOVER):
        key = torch.where(want > 0, want, _BIG)
        perm = torch.sort(key, stable=True).indices
        inv = torch.argsort(perm)
        sub = rays.take(perm)
        sub = Rays(sub.origin, sub.direction, sub.tmin, torch.minimum(sub.tmax, t[perm]))
        (t2, tri2), st2, out2, _ = trace_rays_lane(
            tb, packed, sub, active=(want > 0)[perm], any_hit=any_hit, raw=True, budget=b,
            stack=stack)
        improved = (tri2 >= 0)[inv]
        t = torch.where(improved, t2[inv], t)
        tri = torch.where(improved, tri2[inv], tri)
        box = box + st2.box_tests[inv]
        trit = trit + st2.tri_tests[inv]
        want = wanted(out2, tri2)[inv]
    return _finish(packed, rays, t, tri, box, trit, want, any_hit, raw)


def _row(out, k: int):
    """Out row ``k`` (a count) per ray, as int32."""
    return out[:, k, :].reshape(-1).to(torch.int32)


def _take_packets(block, perm):
    """The rays of a [num_p, rows, 128] block in the order ``perm`` (new ray
    i is old ray perm[i]). Each ray's words are gathered as one contiguous
    row of the per-ray transpose: a gather straight in the packet layout
    reads every word from another 32-byte sector and measured slower on the
    card (PERF.md)."""
    return _per_packet(_per_ray(block)[perm])


def _resume_rounds(tb, packed, rays, active, any_hit, raw, rounds, stack):
    """Suspend/resume rounds shared by the wave and phase drivers. Each
    round is (budget, no_switch). Between rounds, rays flagged for stack
    overflow restart from the root with their (t, tri) standing, and rays
    are regrouped by the treelet they want next (finished rays last). Only
    the flagged rays' states are rewritten, and the rounds end early once
    no ray wants more work (a later launch would change nothing)."""
    num = rays.origin.shape[0]
    dev = rays.origin.device
    root = int(tb.root_tid)
    rays8 = rays8_of(rays, active)
    state = init_state(root, rays.tmax, active, stack)
    orig = torch.arange(num, device=dev)
    box = torch.zeros((num,), dtype=torch.int32, device=dev)
    trit = torch.zeros((num,), dtype=torch.int32, device=dev)
    for i, (b, ns) in enumerate(rounds):
        out, state = lane_traverse(tb.tables, tb.columns, rays8, state, root, lw=tb.leaf_width,
                                   any_hit=any_hit, budget=b, no_switch=ns)
        box = box + _row(out, 2)
        trit = trit + _row(out, 3)
        want = _row(out, 7)
        if i == len(rounds) - 1:
            break
        ovf = (want > 0) & (_row(out, 6) > stack - 8)
        # overflowed rays: row 0 -> root entry, rows 3.. -> empty; tbest and
        # tribest (rows 1-2) stand
        flagged = torch.nonzero(ovf).reshape(-1)
        pk, lane = flagged // 128, flagged % 128
        state[pk, 0, lane] = (root << 9) | 1
        state[pk, 3:, lane] = 0
        want = torch.where(ovf, root + 1, want)
        if not bool((want > 0).any()):
            break
        perm = torch.sort(torch.where(want > 0, want, _BIG), stable=True).indices
        state, rays8 = _take_packets(state, perm), _take_packets(rays8, perm)
        box, trit, orig = box[perm], trit[perm], orig[perm]
    t = out[:, 0, :].reshape(num)
    tri = f2i(out[:, 1, :]).reshape(num)
    inv = torch.argsort(orig)
    return _finish(packed, rays, t[inv], tri[inv], box[inv], trit[inv], want[inv], any_hit, raw)


def trace_rays_lane_wave(tb: TreeletBVH, packed: PackedPairs, rays: Rays, active=None,
                         any_hit: bool = False, raw: bool = False,
                         budgets: Optional[Sequence[int]] = None, stack: int = STACK):
    """Suspend/resume driver: budgeted rounds export every ray's full state;
    rays are regrouped by wanted treelet and resume exactly where they
    stopped. Then unbudgeted rounds (1 + RECOVER)."""
    budgets = (48, 48, 48) if budgets is None else tuple(budgets)
    rounds = [(b, False) for b in budgets] + [(0, False)] * (1 + RECOVER)
    return _resume_rounds(tb, packed, rays, active, any_hit, raw, rounds, stack)


def trace_rays_lane_phase(tb: TreeletBVH, packed: PackedPairs, rays: Rays, active=None,
                          any_hit: bool = False, raw: bool = False,
                          phases: Optional[int] = None, stack: int = STACK):
    """Treelet-major driver: ``phases`` no-switch rounds (a ray stops at its
    first treelet change; rays are regrouped by wanted treelet between
    rounds), then unbudgeted switching rounds (1 + RECOVER)."""
    phases = 10 if phases is None else phases
    rounds = [(0, True)] * phases + [(0, False)] * (1 + RECOVER)
    return _resume_rounds(tb, packed, rays, active, any_hit, raw, rounds, stack)


DRIVERS = ("wave", "phase", "restart", "single")


def make_lane_tracer(any_hit: bool = False, driver: str = "wave",
                     budgets: Optional[Sequence[int]] = None, phases: Optional[int] = None,
                     stack: int = STACK):
    """Tracer ``(tb, packed, rays, active=None) -> (HitRecord, TraceStats)``
    over a TreeletBVH, for any ray count: a batch that is not a multiple of
    128 is padded by repeating its last ray, dead, and the outputs are cut
    back. Drivers: ``wave`` (default), ``phase``, ``restart`` and
    ``single`` (one unbudgeted launch plus the recovery rounds)."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown lane driver {driver!r}; choose from {DRIVERS}")

    def run(tb, packed, rays, active):
        kw = dict(active=active, any_hit=any_hit, stack=stack)
        if driver == "phase":
            return trace_rays_lane_phase(tb, packed, rays, phases=phases, **kw)
        if driver == "wave":
            return trace_rays_lane_wave(tb, packed, rays, budgets=budgets, **kw)
        return trace_rays_lane_restart(tb, packed, rays,
                                       budgets=() if driver == "single" else budgets, **kw)

    def tracer(tb, packed, rays, active=None):
        num = rays.origin.shape[0]
        rec, stats = run(tb, packed, *pad_to_packets(rays, active))
        return _map(lambda a: a[:num], rec), _map(lambda a: a[:num], stats)

    return tracer
