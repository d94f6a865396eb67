"""Fat wide-BVH traversal: the K6 kernel's wrapper, its plain version, and
the tracer front end.

Port of ``tpu_raytracing/ops/pallas_traverse.py`` (``pad_rows_256``,
``_PUSH_NETWORK``, ``trace_rays_pallas`` -> ``trace_rays_fat``,
``make_pallas_tracer`` -> ``make_fat_tracer``). The Pallas kernel
``_kernel`` becomes the CUDA kernel ``csrc/fat_traverse.cu``;
``fat_traverse`` is its wrapper. Given CPU tensors it runs
``trace_fat_plain``, the same per-ray algorithm vectorised over rays in
PyTorch; given CUDA tensors it launches the kernel or raises. The two agree
bit for bit on all six outputs (the kernel is built with ``-fmad=false``
and keeps the plain version's operation order). ``fat_traverse(...,
count=True)`` launches K6's counting instantiation, which also returns each
ray's box tests and triangle-entry tests (the counts the render modes read,
``trace/wide_fat.py``); it has a launch count of its own. ``fat_traverse(...,
any_hit=True)`` launches K6's any-hit instantiation, which ends a ray at its
first occluder (``tt <= tmax``) and returns hit, t = tmax and zero prim,
tri, u and v; its plain version is ``trace_fat_plain(..., any_hit=True)``,
and it has a launch count of its own too.
``fat_traverse_cycles`` is a diagnostic on the card: the clock64 split of
K6's pop phases, or of the one-thread-per-ray kernel K6 replaced.

What is computed, per ray, from wide row 0: per pop, the slab test of all
8 entries, ``(back >= front) & (front <= t) & (back >= tmin)`` with the
safe inverse direction (components below 1e-30 clamped to +-1e-30);
for a Tri entry that the box test accepts, Möller-Trumbore on (a, b, c)
and then, if the entry's count is > 0, on (c, b, q3), each accepting
``tt <= t`` (so on an equal t the later test wins) and recording
``tri = child << 1`` or ``(child << 1) + 1`` and ``prim = p0`` or ``p1``;
Box entries the box test accepts are sorted by the 19-comparator network
(descending distance, ties to the higher child id as nearer) and pushed
far to near. Dead rays enter with tmax = -1, as in the reference.

Differences from the TPU kernel, both deliberate:

* The TPU kernel walks one 128-ray packet per program and orders children
  by the packet's minimum entry distance; here each ray walks alone and
  orders them by its own entry distance. The closest hit is the same
  function; only rays whose closest triangles tie exactly on t may report
  another of them.
* The TPU kernel's 64-entry stack drops pushes silently when full. Here
  the stack holds ``STACK`` entries, enough for any tree the Karras build
  makes (below), and a push past it sets the overflow flag and stops the
  ray; ``path_trace`` raises on the flag. ``check_stack_depth`` holds
  another tree (an SAH tree) to the same bound before it is collapsed.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from tpu_raytracing_torch.bvh.lbvh import MAX_TREE_DEPTH
from tpu_raytracing_torch.bvh.types import BVH, CHILD_BOX, CHILD_NONE, CHILD_TRI
from tpu_raytracing_torch.bvh.wide import WIDE
from tpu_raytracing_torch.ops import _cuda_build
from tpu_raytracing_torch.ops.intersect import safe_inverse
from tpu_raytracing_torch.trace.brute import HitRecord
from tpu_raytracing_torch.trace.packet import tile_reorder, tile_restore
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import TraceStats, i2f
from tpu_raytracing_torch.utils import timing

ROW_WORDS = 256
# Optimal 8-input sorting network (19 comparators).
_PUSH_NETWORK = [
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6), (0, 4), (3, 7),
    (1, 5), (2, 6),
    (1, 4), (3, 6),
    (2, 4), (3, 5),
    (3, 4),
]
# A pop pushes at most 8 entries and removes 1, so a tree of L wide levels
# needs at most 7 L + 1 slots; a Karras tree is at most MAX_TREE_DEPTH
# binary levels deep, 1 + ceil((64 - 2) / 3) = 22 wide levels.
STACK = 7 * (1 + -(-(MAX_TREE_DEPTH - 2) // 3)) + 1
_TRI_EPS = 1e-9
_F32_MAX = float(torch.finfo(torch.float32).max)
# Rays per chunk of the plain version: bounds its [chunk, STACK] stack and
# its [chunk, 256] row gathers (256 MiB each).
_PLAIN_CHUNK = 1 << 18

# K6 launches since the count was last set to 0: fat_traverse adds one
# where it launches the kernel and nowhere else; count_launch_count and
# any_launch_count likewise for the counting and any-hit instantiations.
launch_count = 0
count_launch_count = 0
any_launch_count = 0
# clock64 phases of fat_traverse_cycles, in the order of its cycles rows
PHASES = ("node loads and box tests", "Tri entries", "sort, push and pop")


def binary_depth(bvh: BVH) -> int:
    """Deepest slot's depth below its root group (root slots have depth
    0), by pointer doubling on parent links until every pointer reaches a
    root; one host read."""
    ptr = bvh.parent.to(torch.int64)
    slots = torch.arange(bvh.num_slots, device=ptr.device)
    depth = (ptr != slots).to(torch.int64)
    for _ in range(max(bvh.num_slots, 2).bit_length()):
        depth = depth + depth[ptr]
        ptr = ptr[ptr]
    return int(depth.max())


def check_stack_depth(bvh: BVH) -> None:
    """Raise unless K6's ``STACK`` covers the collapse of ``bvh``: row 0
    holds the root group's first 2 (a pair root) or 3 binary levels, each
    further row 3, and a tree of L wide levels needs at most 7 L + 1 stack
    slots. The Karras build always passes; a binned-SAH tree can in
    principle go deeper (its midpoint levels past the SAH ones,
    ``bvh/sah.py:frontier_build``)."""
    check_depth(binary_depth(bvh), int(bvh.root_count))


def check_depth(depth: int, root_count: int) -> None:
    """``check_stack_depth`` of a tree ``depth`` binary levels deep whose
    root group has ``root_count`` slots."""
    base = 2 if root_count == 2 else 3
    levels = 1 + -(-max(depth - base, 0) // 3)
    if 7 * levels + 1 > STACK:
        raise ValueError(
            f"the tree is {depth} binary levels deep ({levels} wide levels): K6's stack of "
            f"{STACK} entries covers at most {(STACK - 1) // 7} wide levels")


def pad_rows_256(rows: torch.Tensor) -> torch.Tensor:
    """[W, 192] fat rows -> [W, 256] int32 rows, zero padded.

    The reference returns an int and a float view of the padded rows,
    because Mosaic has no scalar bitcast; the kernel here reinterprets the
    one int32 array in place.
    """
    return torch.nn.functional.pad(rows, (0, ROW_WORDS - rows.shape[1])).contiguous()


def _mt(a, b, c, o, d, tmn, t):
    """Möller-Trumbore in the kernel's operation order: (acc, tt, uu, vv)."""
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
           & (tt >= tmn) & (tt <= t))
    return acc, tt, uu, vv


def _plain_chunk(rows, origin, direction, tmin, tmax, out, counts, any_hit):
    """trace_fat_plain on one chunk of rays; writes into ``out``."""
    dev = origin.device
    num = origin.shape[0]
    inv = safe_inverse(direction)
    t = tmax.clone()
    hit = torch.zeros((num,), dtype=torch.int32, device=dev)
    prim = torch.zeros((num,), dtype=torch.int32, device=dev)
    tri = torch.zeros((num,), dtype=torch.int32, device=dev)
    u = torch.zeros((num,), dtype=torch.float32, device=dev)
    v = torch.zeros((num,), dtype=torch.float32, device=dev)
    stack = torch.zeros((num, STACK), dtype=torch.int32, device=dev)
    sp = torch.ones((num,), dtype=torch.int64, device=dev)  # root row 0 at slot 0
    overflow = torch.zeros((), dtype=torch.bool, device=dev)

    while True:
        r = torch.nonzero(sp > 0).reshape(-1)
        if r.numel() == 0:
            break
        sp[r] -= 1
        node = stack[r, sp[r]].to(torch.int64)
        row = rows[node]  # [Rl, 256]
        rf = i2f(row)
        o = tuple(origin[r, k] for k in range(3))
        d = tuple(direction[r, k] for k in range(3))
        ix, iy, iz = (inv[r, k] for k in range(3))
        tmn = tmin[r]
        tc, hc, pc, trc, uc, vc = t[r], hit[r], prim[r], tri[r], u[r], v[r]
        # any-hit: the rays this pop finds occluded (t stays tmax)
        done = torch.zeros_like(tmn, dtype=torch.bool)
        cand_d, cand_c = [], []
        if counts is not None:
            counts["pops"][r] += 1
            counts["visited"][node] = True
        for e in range(WIDE):
            meta = row[:, e * 8 + 6]
            ntype = meta & 3
            child = meta >> 5
            ccount = (meta >> 2) & 7
            b = e * 8
            tx0 = (rf[:, b + 0] - o[0]) * ix
            ty0 = (rf[:, b + 1] - o[1]) * iy
            tz0 = (rf[:, b + 2] - o[2]) * iz
            tx1 = (rf[:, b + 3] - o[0]) * ix
            ty1 = (rf[:, b + 4] - o[1]) * iy
            tz1 = (rf[:, b + 5] - o[2]) * iz
            front = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                                  torch.minimum(tz0, tz1))
            back = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                                 torch.maximum(tz0, tz1))
            box_hit = (back >= front) & (front <= tc) & (back >= tmn)

            leaf = box_hit & (ntype == CHILD_TRI)
            p = 64 + e * 16
            va = (rf[:, p + 0], rf[:, p + 1], rf[:, p + 2])
            vb = (rf[:, p + 3], rf[:, p + 4], rf[:, p + 5])
            vc3 = (rf[:, p + 6], rf[:, p + 7], rf[:, p + 8])
            vq = (rf[:, p + 9], rf[:, p + 10], rf[:, p + 11])
            acc, tt, uu, vv = _mt(va, vb, vc3, o, d, tmn, tc)
            take = leaf & acc
            if any_hit:
                done |= take
            else:
                tc = torch.where(take, tt, tc)
                hc = torch.where(take, 1, hc)
                pc = torch.where(take, row[:, p + 12], pc)
                trc = torch.where(take, child << 1, trc)
                uc = torch.where(take, uu, uc)
                vc = torch.where(take, vv, vc)
            second = leaf & (ccount > 0)
            acc, tt, uu, vv = _mt(vc3, vb, vq, o, d, tmn, tc)
            take = second & acc
            if any_hit:
                done |= take
            else:
                tc = torch.where(take, tt, tc)
                hc = torch.where(take, 1, hc)
                pc = torch.where(take, row[:, p + 13], pc)
                trc = torch.where(take, (child << 1) + 1, trc)
                uc = torch.where(take, uu, uc)
                vc = torch.where(take, vv, vc)
            if counts is not None:
                counts["box_tests"][r] += (ntype != CHILD_NONE).to(torch.int32)
                counts["tri_tests"][r] += leaf.to(torch.int32) + second.to(torch.int32)
                counts["tri_entry_tests"][r] += leaf.to(torch.int32)
                counts["visited_tri"][node[leaf], e] = True

            push = box_hit & (ntype == CHILD_BOX)
            cand_d.append(torch.where(push, front, -_F32_MAX))
            cand_c.append(torch.where(push, child, -1))

        # descending by distance, ties: the higher child id nearer
        for a, b in _PUSH_NETWORK:
            swap = (cand_d[a] < cand_d[b]) | ((cand_d[a] == cand_d[b]) & (cand_c[a] > cand_c[b]))
            cand_d[a], cand_d[b] = (torch.where(swap, cand_d[b], cand_d[a]),
                                    torch.where(swap, cand_d[a], cand_d[b]))
            cand_c[a], cand_c[b] = (torch.where(swap, cand_c[b], cand_c[a]),
                                    torch.where(swap, cand_c[a], cand_c[b]))
        spr = sp[r]
        stopped = torch.zeros_like(tmn, dtype=torch.bool)
        for e in range(WIDE):
            ok = (cand_c[e] >= 0) & ~stopped & ~done
            full = ok & (spr >= STACK)
            stopped |= full
            ok &= ~full
            stack[r[ok], spr[ok]] = cand_c[e][ok]
            spr = spr + ok.to(torch.int64)
        sp[r] = torch.where(stopped | done, 0, spr)
        overflow |= stopped.any()
        hc = hc | done.to(torch.int32)
        t[r], hit[r], prim[r], tri[r], u[r], v[r] = tc, hc, pc, trc, uc, vc

    for dst, src in zip(out[:6], (hit, t, prim, tri, u, v)):
        dst.copy_(src)
    out[6].copy_(out[6] | overflow.to(torch.int32))


def trace_fat_plain(rows, origin, direction, tmin, tmax, counts: Optional[dict] = None,
                    any_hit: bool = False):
    """K6's plain PyTorch version: the kernel's per-ray algorithm,
    vectorised over rays, one pop per live ray per iteration, with an
    explicit [R, STACK] stack; rays run in chunks of ``_PLAIN_CHUNK``.

    Returns (hit i32, t f32, prim i32, tri i32, u f32, v f32, overflow
    i32 [1]). With ``any_hit``, the any-hit instantiation's: a ray stops
    after the pop in which a triangle accepts with ``tt <= tmax`` (hit 1,
    no pushes), t stays tmax, and prim, tri, u and v stay 0. With
    ``counts`` (a dict), also fills per-ray ``pops``, ``box_tests``
    (non-empty entries tested), ``tri_tests`` (triangle tests run, one or
    two an entry) and ``tri_entry_tests`` (Tri entries whose box the ray
    passes: the counting instantiation's count), and the ``visited`` rows
    [W] and ``visited_tri`` Tri entries [W, 8] whose pair words were
    read.
    """
    num = origin.shape[0]
    dev = origin.device
    out = [torch.empty((num,), dtype=dt, device=dev) for dt in (
        torch.int32, torch.float32, torch.int32, torch.int32, torch.float32, torch.float32)]
    out.append(torch.zeros((1,), dtype=torch.int32, device=dev))
    if counts is not None:
        for key in ("pops", "box_tests", "tri_tests", "tri_entry_tests"):
            counts[key] = torch.zeros((num,), dtype=torch.int32, device=dev)
        counts["visited"] = torch.zeros((rows.shape[0],), dtype=torch.bool, device=dev)
        counts["visited_tri"] = torch.zeros((rows.shape[0], WIDE), dtype=torch.bool, device=dev)
    for s in range(0, num, _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, num)
        sub = None
        if counts is not None:
            sub = dict(counts, **{k: counts[k][s:e] for k in (
                "pops", "box_tests", "tri_tests", "tri_entry_tests")})
        _plain_chunk(rows, origin[s:e], direction[s:e], tmin[s:e], tmax[s:e],
                     [x[s:e] for x in out[:6]] + [out[6]], sub, any_hit)
    return tuple(out)


_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_PROFILE_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int] + [ctypes.c_void_p] * 2
_COUNT_ARGTYPES = _ARGTYPES + [ctypes.c_void_p] * 2


def _check_operands(rows, origin, direction, tmin, tmax) -> None:
    dev = origin.device
    specs = [("rows", rows, torch.int32, 2), ("origin", origin, torch.float32, 2),
             ("direction", direction, torch.float32, 2), ("tmin", tmin, torch.float32, 1),
             ("tmax", tmax, torch.float32, 1)]
    for name, x, dtype, ndim in specs:
        if x.device != dev or x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
            raise ValueError(
                f"fat_traverse: {name} must be a contiguous {ndim}-d {dtype} tensor "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if rows.data_ptr() % 16:
        raise ValueError("fat_traverse: rows are not 16-byte aligned")
    num = origin.shape[0]
    if rows.shape[1] != ROW_WORDS or rows.shape[0] < 1:
        raise ValueError(f"fat_traverse: the kernel takes rows [W, {ROW_WORDS}] (pad_rows_256), "
                         f"got {tuple(rows.shape)}")
    if direction.shape != (num, 3) or origin.shape != (num, 3) or tmin.shape != (num,) \
            or tmax.shape != (num,):
        raise ValueError("fat_traverse: ray arrays disagree in shape")


def _launch(entry: str, argtypes, rows, origin, direction, tmin, tmax, *extra,
            library: str = "fat_traverse"):
    """Launches a C entry of the built ``library``; returns (hit, t, prim,
    tri, u, v, overflow [1])."""
    _check_operands(rows, origin, direction, tmin, tmax)
    fn = getattr(_cuda_build.load_library(library), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    num = origin.shape[0]
    dev = origin.device
    out = [torch.empty((num,), dtype=dt, device=dev) for dt in (
        torch.int32, torch.float32, torch.int32, torch.int32, torch.float32, torch.float32)]
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    if num == 0:
        return (*out, overflow)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with timing.span("k6"):
        err = fn(rows.data_ptr(), origin.data_ptr(), direction.data_ptr(), tmin.data_ptr(),
                 tmax.data_ptr(), *(x.data_ptr() for x in out), overflow.data_ptr(), num,
                 STACK, *extra, stream)
    if err != 0:
        raise RuntimeError(f"fat_traverse kernel launch failed: cudaError {err}")
    return (*out, overflow)


def fat_traverse(rows, origin, direction, tmin, tmax, count: bool = False,
                 any_hit: bool = False):
    """K6: closest hit of every ray over padded fat rows (see the module
    docstring). rows [W, 256] i32 from ``pad_rows_256``, origin/direction
    [R, 3] f32 (direction as given: the kernel forms the safe inverse),
    tmin/tmax [R] f32 (tmax = -1 for dead rays). Returns (hit, t, prim,
    tri, u, v, overflow [1]); with ``count``, from the counting
    instantiation, then also each ray's box tests and triangle-entry tests
    (int32 [R]: the plain version's ``box_tests`` and ``tri_entry_tests``);
    with ``any_hit``, from the any-hit instantiation (``trace_fat_plain``'s
    ``any_hit``).

    CPU tensors run ``trace_fat_plain``; CUDA tensors launch the kernel or
    raise. The launch (the plain version on the CPU) is the span ``k6``.
    """
    global launch_count, count_launch_count, any_launch_count
    if count and any_hit:
        raise ValueError("fat_traverse: the any-hit instantiation does not count")
    if origin.device.type == "cpu":
        counts = {} if count else None
        with timing.span("k6"):
            out = trace_fat_plain(rows, origin, direction, tmin, tmax, counts=counts,
                                  any_hit=any_hit)
        return out if not count else (*out, counts["box_tests"], counts["tri_entry_tests"])
    if origin.device.type != "cuda":
        raise ValueError(f"fat_traverse: unsupported device {origin.device}")
    if any_hit:
        out = _launch("fat_traverse_any_launch", _ARGTYPES, rows, origin, direction, tmin, tmax)
        any_launch_count += 1
        return out
    if not count:
        out = _launch("fat_traverse_launch", _ARGTYPES, rows, origin, direction, tmin, tmax)
        launch_count += 1
        return out
    box, tri = (torch.empty((origin.shape[0],), dtype=torch.int32, device=origin.device)
                for _ in range(2))
    out = _launch("fat_traverse_count_launch", _COUNT_ARGTYPES, rows, origin, direction, tmin,
                  tmax, box.data_ptr(), tri.data_ptr())
    count_launch_count += 1
    return (*out, box, tri)


def fat_traverse_cycles(rows, origin, direction, tmin, tmax, *, per_thread: bool = False):
    """A diagnostic on CUDA tensors, off every frame path: ``fat_traverse``'s
    outputs from K6's clock64-profiled form, then the [3, R] int64 cycles
    each ray spent in the ``PHASES`` (the warp's time at each phase's end,
    booked to every ray in the pop) and the [R] triangle tests run for each
    ray. With ``per_thread``, the same from the one-thread-per-ray kernel K6
    replaced, split per lane (a lane books its wait for other lanes'
    triangles to its own next phase). Counts no K6 launch."""
    if origin.device.type != "cuda":
        raise ValueError("fat_traverse_cycles: cycle counts exist only on the card")
    cycles = torch.zeros((len(PHASES) + 1, origin.shape[0]), dtype=torch.int64,
                         device=origin.device)
    out = _launch("fat_traverse_profile_launch", _PROFILE_ARGTYPES, rows, origin, direction,
                  tmin, tmax, int(per_thread), cycles.data_ptr())
    return (*out, cycles[:len(PHASES)], cycles[len(PHASES)])


def kernel_operands(rays: Rays, active=None):
    """(origin, direction, tmin, tmax) as K6 takes them; dead rays (active
    False) get tmax = -1, so no triangle accepts."""
    tmax = rays.tmax if active is None else torch.where(active, rays.tmax, -1.0)
    return (rays.origin.contiguous(), rays.direction.to(torch.float32).contiguous(),
            rays.tmin.contiguous(), tmax.contiguous())


def trace_rays_fat(rows256, rays: Rays, active=None,
                   any_hit: bool = False) -> Tuple[HitRecord, TraceStats]:
    """Trace rays with K6 over ``pad_rows_256`` rows (see
    ``kernel_operands`` for dead rays), or with its any-hit instantiation.
    The statistics carry zero test counts, as the reference's, and the
    overflow flag."""
    hit, t, prim, tri, u, v, overflow = fat_traverse(rows256, *kernel_operands(rays, active),
                                                     any_hit=any_hit)
    rec = HitRecord(hit=hit.to(torch.bool), t=t, prim_id=prim, tri_id=tri, bary_u=u, bary_v=v)
    zeros = torch.zeros_like(prim)
    return rec, TraceStats(box_tests=zeros, tri_tests=zeros, overflow=overflow)


def make_fat_tracer(rows256, width: int, height: int):
    """Tiled tracer over 16 x 8 screen tiles using K6.

    With ``rows256=None`` the padded rows ride in the tracer's ``trav``
    argument, as with the reference's ``make_pallas_tracer``.
    """

    def tracer(trav, pairs, rays, active=None):
        del pairs
        rows = rows256 if rows256 is not None else trav
        tiled = Rays(*(tile_reorder(getattr(rays, f), width, height, 16, 8)
                       for f in ("origin", "direction", "tmin", "tmax")))
        act = None if active is None else tile_reorder(active, width, height, 16, 8)
        rec, stats = trace_rays_fat(rows, tiled, active=act)
        rec = dataclasses.replace(rec, **{
            f.name: tile_restore(getattr(rec, f.name), width, height, 16, 8)
            for f in dataclasses.fields(rec)})
        return rec, stats

    return tracer
