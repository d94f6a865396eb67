"""Split-BVH traversal: the K1 kernel's wrapper, its plain version, and the
tracer front end.

Port of ``tpu_raytracing/trace/split_pallas.py`` (``LEAFW``,
``trace_rays_split_pallas`` -> ``trace_rays_split``,
``make_split_pallas_tracer`` -> ``make_split_tracer`` with ``sort_mode``
None and ``"presorted"``). The Pallas kernels ``_kernel_v3``, ``_kernel_v4``,
``_kernel_v5`` and ``_kernel`` (v2) compute one function and differ only in
how they schedule DMAs and scalar work on the TPU; on the card one CUDA
kernel, ``csrc/split_trace.cu``, stands for all four (closest-hit and
any-hit instantiations) with no selector. The reference's version switch
(``split_pallas.py:1635-1818``, ``TPURT_SPLIT_V``) has no counterpart.

``split_traverse`` is the kernel's wrapper. Given CPU tensors it runs
``trace_split_plain``, the same per-ray algorithm vectorised over rays in
PyTorch; given CUDA tensors it launches the kernel or raises. The two agree
bit for bit (the kernel is built with ``-fmad=false`` and keeps the plain
version's operation order).

The glue around each K1 call is one launch before it and one after it on
the card, both kernels of ``csrc/split_front.cu``: ``kernel_operands``
(the dead rays' empty interval and the direction clamp; plain version
``kernel_operands_plain``) and ``traverse.reconstruct`` (the hit record;
``reconstruct_plain``). The CPU runs the plain versions.

Statistics are per ray: ``box_tests = inner_pops * w`` and
``tri_tests = leaf_pops * 2 * leafw``. The TPU kernels count pops per packet
of k rays and give every ray of the packet the packet's count, so each of
their per-ray values is at least the largest per-ray value of the packet's
rays. The tests never compare the two.

``trace_rays_split(raw=True)`` returns K1's (t, tri) before the hit
record is rebuilt, for ``trace/instanced_split.py`` and
``trace/binned.py``. ``packet_tags`` (``split_pallas.py:1585``) gives
each packet of ``k`` consecutive rays a start tag, the reference's
``ptag``: an even tag 2 r starts the packet's rays at inner row r, an odd
tag 2 s + 1 at the leaf window from pair s. The wrapper expands them to one
tag per ray (``split_traverse(start=...)``); without them every ray starts
at the root, tag 0.

``split_traverse_cycles`` is a diagnostic off every frame path: K1's
clock64 instantiation, on the card only, splitting each ray's warp cycles
into inner rows, its own leaf windows and its wait at a leaf; at 16 wide
it also profiles the per-lane inner rows the half-warp design replaced.

``make_split_tracer``'s sort modes (``split_pallas.py:1873-2020``):
``"presorted"`` traces the caller's order; ``"binned"`` calls
``trace/binned.py:trace_rays_binned`` on it; ``"origin"`` and
``"cell_octant"`` sort the rays by a Morton key of their origins (and
their direction octant), dead rays last, trace, and restore the order;
``sort_origin=True`` (with ``sort_mode`` None) sorts as ``"origin"``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tpu_raytracing_torch.bvh.types import CHILD_TRI
from tpu_raytracing_torch.ops import _cuda_build
from tpu_raytracing_torch.ops.morton import morton3d
from tpu_raytracing_torch.trace.packet import (
    crop_frame,
    pad_frame,
    pad_live_mask,
    tile_reorder,
    tile_restore,
)
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import (
    PackedPairs,
    TraceStats,
    check_kernel_operands,
    i2f,
    reconstruct,
)
from tpu_raytracing_torch.utils import timing

# Rays per screen tile for the tiled tracers (16 x K/16 pixels).
K = 256
# Pairs per leaf window; emit_split_views(leaf_width=...) must match.
LEAFW = 64
# The widest window the kernel takes: four pair slots per lane of a warp.
MAX_LEAFW = 128
# Inner row widths the kernel is instantiated for (split_pallas.py:129).
WIDTHS = (8, 16)
_F32_MAX = float(torch.finfo(torch.float32).max)
_TRI_EPS = 1e-9
# Rays per chunk of the plain version: bounds its [chunk, leafw] temporaries.
_PLAIN_CHUNK = 1 << 16

# K1 launches since the count was last set to 0: split_traverse adds one
# where it launches the kernel and nowhere else.
launch_count = 0
# Operand-kernel launches (csrc/split_front.cu) since the count was last set
# to 0: kernel_operands adds one where it launches the kernel and nowhere else.
operands_launch_count = 0


def _mt(a, b, c, o, d, tmn, t_cur):
    """Möller-Trumbore over [R, leafw] vertex components, in the kernel's
    operation order; returns t where accepted, else F32_MAX."""
    (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = a, b, c
    ox, oy, oz = o
    dx, dy, dz = d
    e1x, e1y, e1z = b0 - a0, b1 - a1, b2 - a2
    e2x, e2y, e2z = c0 - a0, c1 - a1, c2 - a2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    det = e1x * hx + e1y * hy + e1z * hz
    degen = (det > -_TRI_EPS) & (det < _TRI_EPS)
    f = 1.0 / det
    sx, sy, sz = ox - a0, oy - a1, oz - a2
    uu = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = f * (dx * qx + dy * qy + dz * qz)
    tt = f * (e2x * qx + e2y * qy + e2z * qz)
    acc = (~degen & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (uu + vv <= 1.0)
           & (tt >= tmn) & (tt <= t_cur))
    return torch.where(acc, tt, _F32_MAX)


def _plain_chunk(inner, pairs, origin, direction, tmin, tmax, start, leafw, any_hit,
                 stack_cap, out, visited):
    """trace_split_plain on one chunk of rays; writes into ``out``."""
    dev = origin.device
    num, w = origin.shape[0], inner.shape[1]
    inv = 1.0 / direction
    t_cur = tmax.clone()
    tri = torch.full((num,), -1, dtype=torch.int32, device=dev)
    ipops = torch.zeros((num,), dtype=torch.int32, device=dev)
    lpops = torch.zeros((num,), dtype=torch.int32, device=dev)
    stack = torch.zeros((num, stack_cap), dtype=torch.int32, device=dev)
    if start is not None:
        stack[:, 0] = start
    sp = torch.ones((num,), dtype=torch.int64, device=dev)  # the start tag (root: 0) at slot 0
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    slots = torch.arange(leafw, device=dev)
    enc0 = (slots * 2)[None, :]

    while True:
        live = torch.nonzero(sp > 0).reshape(-1)
        if live.numel() == 0:
            break
        sp[live] -= 1
        tag = stack[live, sp[live]]
        is_leaf = (tag & 1) == 1

        ri = live[~is_leaf]
        if ri.numel():
            ipops[ri] += 1
            if visited is not None:
                visited["inner"][(tag[~is_leaf] >> 1).to(torch.int64)] = True
            ent = inner[(tag[~is_leaf] >> 1).to(torch.int64)]  # [Ri, w, 8]
            box = i2f(ent[..., :6])
            meta = ent[..., 6]
            ntype = meta & 3
            o, iv = origin[ri], inv[ri]
            tx0 = (box[..., 0] - o[:, 0:1]) * iv[:, 0:1]
            ty0 = (box[..., 1] - o[:, 1:2]) * iv[:, 1:2]
            tz0 = (box[..., 2] - o[:, 2:3]) * iv[:, 2:3]
            tx1 = (box[..., 3] - o[:, 0:1]) * iv[:, 0:1]
            ty1 = (box[..., 4] - o[:, 1:2]) * iv[:, 1:2]
            tz1 = (box[..., 5] - o[:, 2:3]) * iv[:, 2:3]
            front = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                                  torch.minimum(tz0, tz1))
            back = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                                 torch.maximum(tz0, tz1))
            ok = ((ntype != 0) & (back >= front) & (front <= t_cur[ri, None])
                  & (back >= tmin[ri, None]))
            dist = torch.where(ok, torch.clamp(front, min=0.0), float("inf"))
            # nearest: smallest distance, the higher entry id on a tie
            best = dist.min(dim=1, keepdim=True).values
            e_ids = torch.arange(w, device=dev)
            nearest = torch.where(ok & (dist == best), e_ids, -1).max(dim=1).values
            ctag = ((meta >> 5) << 1) | (ntype == CHILD_TRI).to(torch.int32)
            pushes = [(ok[:, e] & (nearest != e), ctag[:, e]) for e in range(w)]
            near_tag = ctag.gather(1, nearest.clamp(min=0)[:, None])[:, 0]
            pushes.append((nearest >= 0, near_tag))
            stopped = torch.zeros_like(ri, dtype=torch.bool)
            for mask, vals in pushes:
                m = mask & ~stopped
                full = m & (sp[ri] >= stack_cap)
                overflow |= full.any()
                stopped |= full
                m &= ~full
                rows = ri[m]
                stack[rows, sp[rows]] = vals[m]
                sp[rows] += 1
            sp[ri[stopped]] = 0

        rl = live[is_leaf]
        if rl.numel():
            lpops[rl] += 1
            start = (tag[is_leaf] >> 1).to(torch.int64)
            win = pairs[start[:, None] + slots[None, :]]  # [Rl, leafw, 16]
            if visited is not None:
                visited["pairs"][start[:, None] + slots[None, :]] = True
            v = i2f(win[..., :12])
            v0 = (v[..., 0], v[..., 1], v[..., 2])
            v1 = (v[..., 3], v[..., 4], v[..., 5])
            v2 = (v[..., 6], v[..., 7], v[..., 8])
            v3 = (v[..., 9], v[..., 10], v[..., 11])
            o = tuple(origin[rl, i:i + 1] for i in range(3))
            d = tuple(direction[rl, i:i + 1] for i in range(3))
            tmn, tc = tmin[rl, None], t_cur[rl, None]
            ca = _mt(v0, v1, v2, o, d, tmn, tc)
            cb = _mt(v2, v1, v3, o, d, tmn, tc)
            c = torch.minimum(ca, cb)
            enc = enc0 + (cb <= ca).to(torch.int64)
            tm = c.min(dim=1).values
            wenc = torch.where(c == tm[:, None], enc, -1).max(dim=1).values
            take = tm <= t_cur[rl]
            hit_rays = rl[take]
            tri[hit_rays] = (start[take] * 2 + wenc[take]).to(torch.int32)
            if any_hit:
                sp[hit_rays] = 0
            else:
                t_cur[hit_rays] = tm[take]

    out_t, out_tri, out_ip, out_lp, out_ov = out
    out_t.copy_(t_cur)
    out_tri.copy_(tri)
    out_ip.copy_(ipops)
    out_lp.copy_(lpops)
    out_ov |= overflow.to(torch.int32)


def trace_split_plain(inner, pairs, origin, direction, tmin, tmax, *, leafw: int,
                      any_hit: bool, stack_cap: int, start=None, visited=None):
    """K1's plain PyTorch version: the kernel's per-ray algorithm,
    vectorised over rays. Each ray's stack starts with its tag in ``start``
    ([R] int32; None: the root, tag 0). Each iteration pops one tag per live
    ray, runs the slab test on rays at inner rows and Möller-Trumbore on
    rays at leaf windows, with explicit [R, stack_cap] stacks. Rays run in
    chunks of ``_PLAIN_CHUNK`` to bound memory.

    Returns (t f32 [R], tri i32 [R] (-1 = miss), inner_pops i32 [R],
    leaf_pops i32 [R], overflow i32 [1]). With ``visited`` (a dict), also
    marks the ``inner`` rows [ICAP] and ``pairs`` rows [P_pad] that any ray
    read.
    """
    if visited is not None:
        visited["inner"] = torch.zeros((inner.shape[0],), dtype=torch.bool, device=inner.device)
        visited["pairs"] = torch.zeros((pairs.shape[0],), dtype=torch.bool, device=inner.device)
    num = origin.shape[0]
    dev = origin.device
    t = torch.empty((num,), dtype=torch.float32, device=dev)
    tri = torch.empty((num,), dtype=torch.int32, device=dev)
    ipops = torch.empty((num,), dtype=torch.int32, device=dev)
    lpops = torch.empty((num,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    for s in range(0, num, _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, num)
        _plain_chunk(inner, pairs, origin[s:e], direction[s:e], tmin[s:e], tmax[s:e],
                     None if start is None else start[s:e], leafw, any_hit, stack_cap,
                     (t[s:e], tri[s:e], ipops[s:e], lpops[s:e], overflow), visited)
    return t, tri, ipops, lpops, overflow


_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_PROFILE_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int] + [ctypes.c_void_p] * 2
# The phases of ``split_traverse_cycles``: step 1 (inner rows), the leaf
# windows of the ray's own group, the rest of step 2 while the ray waits
# at its leaf (the scheduling and the other groups' windows).
PHASES = ("inner rows", "leaf windows", "leaf wait")


def _check_operands(inner, pairs, origin, direction, tmin, tmax, leafw: int,
                    stack_cap: int, start=None) -> None:
    dev = origin.device
    specs = [("inner", inner, torch.int32, 3), ("pairs", pairs, torch.int32, 2),
             ("origin", origin, torch.float32, 2), ("direction", direction, torch.float32, 2),
             ("tmin", tmin, torch.float32, 1), ("tmax", tmax, torch.float32, 1)]
    if start is not None:
        specs.append(("start", start, torch.int32, 1))
    for name, x, dtype, ndim in specs:
        if x.device != dev or x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
            raise ValueError(
                f"split_traverse: {name} must be a contiguous {ndim}-d {dtype} tensor "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"split_traverse: {name} is not 16-byte aligned")
    num = origin.shape[0]
    if inner.shape[1] not in WIDTHS or inner.shape[2] != 8 or pairs.shape[1] != 16:
        raise ValueError(f"split_traverse: the kernel takes inner [ICAP, 8 or 16, 8] and pairs "
                         f"[P_pad, 16], got {tuple(inner.shape)}, {tuple(pairs.shape)}")
    if direction.shape != (num, 3) or origin.shape != (num, 3) or tmin.shape != (num,) \
            or tmax.shape != (num,) or (start is not None and start.shape != (num,)):
        raise ValueError("split_traverse: ray arrays disagree in shape")
    if not 0 < stack_cap <= 256:
        raise ValueError(f"split_traverse: stack_cap {stack_cap} outside (0, 256]")
    if not 1 <= leafw <= MAX_LEAFW:
        raise ValueError(f"split_traverse: leafw {leafw} outside [1, {MAX_LEAFW}]")
    if pairs.shape[0] < leafw:
        raise ValueError(f"split_traverse: a {leafw}-pair window is longer than the "
                         f"{pairs.shape[0]} pair rows")


def _launch(entry: str, argtypes, inner, pairs, origin, direction, tmin, tmax, leafw: int,
            any_hit: bool, stack_cap: int, start, *extra, library: str = "split_trace"):
    """Launches the C entry ``entry`` of the built ``library``; returns (t,
    tri, inner_pops, leaf_pops, overflow [1])."""
    _check_operands(inner, pairs, origin, direction, tmin, tmax, leafw, stack_cap, start)
    fn = getattr(_cuda_build.load_library(library), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    num = origin.shape[0]
    dev = origin.device
    t = torch.empty((num,), dtype=torch.float32, device=dev)
    tri = torch.empty((num,), dtype=torch.int32, device=dev)
    ipops = torch.empty((num,), dtype=torch.int32, device=dev)
    lpops = torch.empty((num,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    if num == 0:
        return t, tri, ipops, lpops, overflow
    stream = torch.cuda.current_stream(dev).cuda_stream
    with timing.span("k1"):
        err = fn(inner.data_ptr(), pairs.data_ptr(), origin.data_ptr(), direction.data_ptr(),
                 tmin.data_ptr(), tmax.data_ptr(), t.data_ptr(), tri.data_ptr(),
                 ipops.data_ptr(), lpops.data_ptr(), overflow.data_ptr(),
                 None if start is None else start.data_ptr(),
                 num, inner.shape[1], leafw, int(any_hit), stack_cap, *extra, stream)
    if err != 0:
        raise RuntimeError(f"split_trace kernel launch failed: cudaError {err}")
    return t, tri, ipops, lpops, overflow


def split_traverse(inner, pairs, origin, direction, tmin, tmax, *, leafw: int,
                   any_hit: bool, stack_cap: int, start=None):
    """K1: traverse a split BVH for every ray (see the module docstring).

    inner [ICAP, w, 8] i32 (w = 8 or 16 entries a row, one kernel
    instantiation each), pairs [P_pad, 16] i32 with P_pad >= every window
    end, origin/direction [R, 3] f32 (direction already sanitised), tmin/
    tmax [R] f32, start [R] i32 start tags or None (the root); the kernel
    takes windows of 1 <= leafw <= MAX_LEAFW pairs, and ``leafw`` must be
    the tree's ``leaf_width``: a Tri entry's window starts at most at
    num_leaves - leaf_width, so a wider window reads past the live pairs
    and a narrower one skips triangles. Returns (t, tri,
    inner_pops, leaf_pops, overflow [1]).

    CPU tensors run ``trace_split_plain``; CUDA tensors launch the kernel
    or raise. The launch (the plain version on the CPU) is the span
    ``k1``; while ``timing.tracing()``, the counters ``k1.pops`` (inner
    and leaf pops) and ``k1.rays`` (live rays, tmin <= tmax) take its
    work.
    """
    global launch_count
    if origin.device.type == "cpu":
        with timing.span("k1"):
            out = trace_split_plain(inner, pairs, origin, direction, tmin, tmax, leafw=leafw,
                                    any_hit=any_hit, stack_cap=stack_cap, start=start)
    elif origin.device.type != "cuda":
        raise ValueError(f"split_traverse: unsupported device {origin.device}")
    else:
        out = _launch("split_trace_launch", _ARGTYPES, inner, pairs, origin, direction, tmin,
                      tmax, leafw, any_hit, stack_cap, start)
        launch_count += 1
    if timing.tracing():
        _count_work(out[2], out[3], tmin, tmax)
    return out


def _count_work(ipops, lpops, tmin, tmax) -> None:
    """K1's counters: pops and live rays, in two kernels each (the first
    writes int64, where a sum over int32 or bool would cast first)."""
    pops = torch.empty(ipops.shape, dtype=torch.int64, device=ipops.device)
    torch.add(ipops, lpops, out=pops)
    live = torch.empty_like(pops)
    torch.le(tmin, tmax, out=live)
    timing.count("k1.pops", pops.sum())
    timing.count("k1.rays", live.sum())


def split_traverse_cycles(inner, pairs, origin, direction, tmin, tmax, *, leafw: int,
                          any_hit: bool, stack_cap: int, start=None, per_lane: bool = False):
    """A diagnostic on CUDA tensors, off every frame path: ``split_traverse``'s
    outputs from K1's clock64 instantiation, then the [3, R] int64 warp
    cycles booked to each ray in the ``PHASES``, each taken at a
    __syncwarp: a round's inner rows to every ray in the round, a window's
    tests to the rays of its group, the rest of the leaf loop to the other
    rays at a leaf. ``per_lane``
    profiles, at 16 wide, the per-lane inner rows that the half-warp design
    replaced; 8-wide rows run per lane either way. Counts no K1 launch."""
    if origin.device.type != "cuda":
        raise ValueError("split_traverse_cycles: cycle counts exist only on the card")
    cycles = torch.zeros((len(PHASES), origin.shape[0]), dtype=torch.int64, device=origin.device)
    out = _launch("split_trace_profile_launch", _PROFILE_ARGTYPES, inner, pairs, origin,
                  direction, tmin, tmax, leafw, any_hit, stack_cap, start, int(per_lane),
                  cycles.data_ptr())
    return (*out, cycles)


# Added to an instanced call's TraceStats.overflow where its overlaps
# outnumbered its item slots (trace/instanced_split.py:trace_instanced); a
# frame's sum of stack overflow flags stays below it.
CANDIDATE_OVERFLOW = 1 << 16


def check_overflow(overflow: torch.Tensor) -> None:
    """Host check of a traversal overflow flag (``TraceStats.overflow``, or
    a sum of them); raises if set: ``InstancedCandidateOverflow`` where an
    instanced call's overlaps outnumbered its item slots."""
    flags = int(overflow.sum())
    if flags >= CANDIDATE_OVERFLOW:
        from tpu_raytracing_torch.trace.instanced_split import InstancedCandidateOverflow

        raise InstancedCandidateOverflow(
            f"{flags // CANDIDATE_OVERFLOW} instanced call(s) of the frame had more instance "
            "overlaps than item slots (trace/instanced_split.py:trace_instanced, "
            "ITEMS_PER_RAY): their rays' hits past the slots were not traced")
    if flags != 0:
        raise RuntimeError(
            "traversal stack overflow: a split-BVH ray needed more than the stack "
            "bound its views carry (bvh/bucket.py:stack_cap, "
            "bvh/split_convert.py:sah_stack_cap), a scalar, packet or fat wide-BVH ray more "
            "than its stack (trace/traverse.py, trace/packet.py, trace/wide_packet.py, "
            "ops/fat_traverse.py), and was stopped, or a lane ray was still unfinished "
            "after its recovery rounds (trace/lane_trace.py); or a static capacity was "
            "too small: the binned tracer's items (trace/binned.py, cap_factor), the BFS "
            "tracer's visits or levels (trace/wavefront_bfs.py) or the instanced grid's "
            "work list (trace/grid_instanced.py, work_factor)")


def kernel_operands_plain(rays: Rays, active=None):
    """(origin, direction, tmin, tmax) as K1 takes them; the operand
    kernel's plain version (``kernel_operands``).

    Dead rays (``active`` False) get an empty interval (tmin = +max,
    tmax = -max) so no box or triangle accepts. Direction components with
    |d| < 1e-30 become +-1e-30 (-0.0 -> +1e-30) here, outside K1, so its
    1/d stays finite and its slab test NaN-free.
    """
    tmin, tmax = rays.tmin, rays.tmax
    if active is not None:
        tmin = torch.where(active, tmin, _F32_MAX)
        tmax = torch.where(active, tmax, -_F32_MAX)
    d = rays.direction
    d = torch.where(d.abs() < 1e-30, torch.where(d < 0, -1e-30, 1e-30), d)
    return (rays.origin.contiguous(), d.to(torch.float32).contiguous(),
            tmin.contiguous(), tmax.contiguous())


def check_operand_inputs(rays: Rays, active=None) -> None:
    """Raises unless ``kernel_operands``' inputs are what the operand kernel
    takes: origin and direction [R, 3], tmin and tmax [R] float32, active
    [R] bool or None."""
    num = rays.origin.shape[0]
    specs = [("rays.origin", rays.origin, torch.float32, (num, 3)),
             ("rays.direction", rays.direction, torch.float32, (num, 3)),
             ("rays.tmin", rays.tmin, torch.float32, (num,)),
             ("rays.tmax", rays.tmax, torch.float32, (num,))]
    if active is not None:
        specs.append(("active", active, torch.bool, (num,)))
    check_kernel_operands("kernel_operands", specs)


_OPERANDS_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]


def kernel_operands(rays: Rays, active=None):
    """``kernel_operands_plain``'s (origin, direction, tmin, tmax); origin is
    ``rays.origin`` itself. CPU tensors run ``kernel_operands_plain``; CUDA
    tensors launch the operand kernel (``csrc/split_front.cu``), one launch
    a call, or raise."""
    global operands_launch_count
    dev = rays.origin.device
    if dev.type == "cpu":
        return kernel_operands_plain(rays, active)
    if dev.type != "cuda":
        raise ValueError(f"kernel_operands: unsupported device {dev}")
    check_operand_inputs(rays, active)
    num = rays.origin.shape[0]
    direction = torch.empty((num, 3), dtype=torch.float32, device=dev)
    tmin = torch.empty((num,), dtype=torch.float32, device=dev)
    tmax = torch.empty((num,), dtype=torch.float32, device=dev)
    if num == 0:
        return rays.origin, direction, tmin, tmax
    fn = _cuda_build.load_library("split_front").split_operands_launch
    fn.argtypes = _OPERANDS_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(rays.direction.data_ptr(), rays.tmin.data_ptr(), rays.tmax.data_ptr(),
             None if active is None else active.data_ptr(), direction.data_ptr(),
             tmin.data_ptr(), tmax.data_ptr(), num, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_operands kernel launch failed: cudaError {err}")
    operands_launch_count += 1
    return rays.origin, direction, tmin, tmax


def trace_rays_split(views, packed: PackedPairs, rays: Rays, active=None,
                     any_hit: bool = False, packet_tags=None, raw: bool = False, k: int = K):
    """Trace against a SplitBVH: ``views`` (inner, pairs, stack bound) from
    bucket.emit_split_views or split_convert.sah_split_views, with
    ``leaf_width=LEAFW``. See ``kernel_operands`` for dead rays and
    direction sanitising. Any-hit records carry ``rays.tmax`` as
    t. ``packet_tags`` ([R / k] int32) starts each packet of ``k``
    consecutive rays at its tag; the ray count must then be a multiple of
    ``k``. Returns (HitRecord, TraceStats); with ``raw``, ((t, tri),
    TraceStats): K1's winning t and encoded triangle per ray (tri -1 for
    none), before the reconstruction, as ``split_pallas.py:1746-1749``
    returns them.
    """
    inner, pairs, stack_cap = views
    w = inner.shape[1]
    start = None
    if packet_tags is not None:
        num = rays.origin.shape[0]
        if num % k or packet_tags.shape != (num // k,):
            raise ValueError(f"packet_tags: {tuple(packet_tags.shape)} tags for {num} rays "
                             f"in packets of {k}")
        start = packet_tags.to(torch.int32).repeat_interleave(k)
    t, tri, ipops, lpops, overflow = split_traverse(
        inner, pairs, *kernel_operands(rays, active), leafw=LEAFW, any_hit=any_hit,
        stack_cap=stack_cap, start=start)
    if any_hit:
        t = rays.tmax
    stats = TraceStats(box_tests=ipops * w, tri_tests=lpops * (2 * LEAFW), overflow=overflow)
    if raw:
        return (t, tri), stats
    return reconstruct(packed, rays, t, tri, any_hit=any_hit), stats


def _map(fn, obj):
    """Apply ``fn`` to every tensor field of a dataclass."""
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor) and f.name != "overflow"})


# Morton bits below the cell of the "cell_octant" key (the reference's
# default cell_shift, the only value its callers pass)
CELL_SHIFT = 9


def sort_keys(rays: Rays, active=None, sort_mode: str = "origin") -> torch.Tensor:
    """The sort key of ``make_split_tracer``'s ``"origin"`` and
    ``"cell_octant"`` modes (``split_pallas.py:1928-1946``), int64 [R]:
    the 30-bit Morton code of each origin in the origins' bounding box,
    shifted right by 2 (``"origin"``), or by ``CELL_SHIFT`` above the
    direction octant (``"cell_octant"``); dead rays (``active`` False)
    get bit 28, so they sort last."""
    o = rays.origin
    lo = o.amin(dim=0)
    hi = o.amax(dim=0)
    cell = morton3d((o - lo) / torch.clamp(hi - lo, min=1e-20))
    if sort_mode == "cell_octant":
        d = rays.direction
        octant = ((d[:, 0] > 0).to(torch.int64) | ((d[:, 1] > 0).to(torch.int64) << 1)
                  | ((d[:, 2] > 0).to(torch.int64) << 2))
        key = ((cell >> CELL_SHIFT) << 3) | octant
    elif sort_mode == "origin":
        key = cell >> 2
    else:
        raise ValueError(f"no sort key for sort_mode {sort_mode!r}")
    if active is not None:
        key = key | ((~active).to(torch.int64) << 28)
    return key


_SORT_MODES = (None, "presorted", "binned", "origin", "cell_octant")


def make_split_tracer(width: int, height: int, any_hit: bool = False,
                      sort_mode: str = None, sort_origin: bool = False):
    """Tracer ``(views, packed, rays, active=None) -> (HitRecord,
    TraceStats)`` over 16 x (K/16) screen tiles.

    sort_mode None tile-orders a row-major frame (edge-padded to the tile
    grid, pad rays dead, then cropped back); ``"presorted"`` feeds rays in
    the caller's order; ``"binned"`` feeds them in the caller's order to
    ``trace/binned.py:trace_rays_binned`` with packets of K items.
    ``"origin"`` and ``"cell_octant"`` sort the rays by ``sort_keys`` with a
    stable sort, trace them and restore the caller's order: the whole
    record and the statistics for a closest-hit tracer, only ``.hit`` for
    an any-hit tracer (its record's other fields and its statistics stay in
    the sorted order, as the reference's). ``sort_origin`` with sort_mode
    None sorts as ``"origin"`` and restores only ``.hit``, for any-hit
    consumers.
    """
    if sort_mode not in _SORT_MODES:
        raise ValueError(f"unknown split tracer sort_mode {sort_mode!r}; choose from "
                         f"{_SORT_MODES}")
    tw, th = 16, K // 16

    def sorted_trace(views, packed, rays, active, key_mode, hit_only):
        perm = torch.argsort(sort_keys(rays, active, key_mode), stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        srt = rays.take(perm)
        act = None if active is None else active[perm]
        rec, stats = trace_rays_split(views, packed, srt, active=act, any_hit=any_hit)
        if hit_only:
            return dataclasses.replace(rec, hit=rec.hit[inv]), stats
        return _map(lambda a: a[inv], rec), _map(lambda a: a[inv], stats)

    def tracer(views, packed, rays, active=None):
        if sort_mode == "presorted":
            return trace_rays_split(views, packed, rays, active=active, any_hit=any_hit)
        if sort_mode == "binned":
            from tpu_raytracing_torch.trace.binned import trace_rays_binned
            return trace_rays_binned(views, packed, rays, active=active, any_hit=any_hit)
        if sort_mode is not None:
            return sorted_trace(views, packed, rays, active, sort_mode, any_hit)
        if sort_origin:
            return sorted_trace(views, packed, rays, active, "origin", True)
        dev = rays.origin.device
        pw = -(-width // tw) * tw
        ph = -(-height // th) * th
        padded = (pw, ph) != (width, height)
        if padded:
            rays = _map(lambda a: pad_frame(a, width, height, pw, ph), rays)
            live = pad_live_mask(width, height, pw, ph, device=dev)
            active = live if active is None else (
                pad_frame(active, width, height, pw, ph) & live)
        tiled = _map(lambda a: tile_reorder(a, pw, ph, tw, th), rays)
        act = None if active is None else tile_reorder(active, pw, ph, tw, th)
        rec, stats = trace_rays_split(views, packed, tiled, active=act, any_hit=any_hit)
        rec = _map(lambda a: tile_restore(a, pw, ph, tw, th), rec)
        stats = _map(lambda a: tile_restore(a, pw, ph, tw, th), stats)
        if padded:
            rec = _map(lambda a: crop_frame(a, width, height, pw, ph), rec)
            stats = _map(lambda a: crop_frame(a, width, height, pw, ph), stats)
        return rec, stats

    return tracer


def make_frame_tracers(width: int, height: int) -> dict:
    """The four tracers of the path-traced frame, as ``bench.py:251-271``
    sets them up (bench.py's ``c_slots`` schedule TPU packets and have no
    counterpart here): tiled closest-hit and any-hit tracers for the coherent primary and
    primary-shadow passes, presorted ones for the bounce and bounce-shadow
    passes. Returns ``path_trace`` keyword arguments."""
    return dict(
        tracer=make_split_tracer(width, height),
        shadow_tracer=make_split_tracer(width, height, any_hit=True),
        bounce_tracer=make_split_tracer(width, height, sort_mode="presorted"),
        shadow_tracer_bounce=make_split_tracer(width, height, any_hit=True,
                                               sort_mode="presorted"),
    )
