"""Wavefront BVH traversal (reference: TraceRay, src/Tracer.cu:308-374),
packed node and pair rows, and trace statistics.

Port of ``tpu_raytracing/trace/traverse.py`` (the ``_META_*`` and entry
constants, ``TraversalBVH``, ``PackedPairs``, ``TraceStats``, ``pack_bvh``,
``pack_pairs``, ``trace_rays``) and of ``tpu_raytracing/trace/wide_fat.py:
_reconstruct`` (``reconstruct``, which the split, lane, grid and
instanced tracers share; on the card one launch of the record kernel,
``csrc/split_front.cu``, bit-equal to ``reconstruct_plain``, which the CPU
runs). ``trace_rays`` is the scalar tracer, the
reference-exact oracle: every ray pops one (index, count) stack entry per
step, with near-child buffering and ties to the higher child id, triangle
A then B, and per-ray box-test and triangle-test counts. Each step runs
over the rays that still have work, not over all of them.

The reference clamps a push past ``STACK_DEPTH`` onto the top slot without
a word. Here such a ray sets ``TraceStats.overflow`` and stops, and
``path_trace`` raises on the flag.

Rows are int32 with float fields bit-cast in, exactly as in the
reference, so node and pair rows compare bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.types import (
    BVH,
    CHILD_BOX,
    CHILD_NONE,
    CHILD_TRI,
    STACK_DEPTH,
    TrianglePairs,
)
from tpu_raytracing_torch.ops import _cuda_build
from tpu_raytracing_torch.ops.intersect import (
    cross,
    dot,
    intersect_ray_aabb,
    intersect_ray_triangle,
)
from tpu_raytracing_torch.trace.brute import HitRecord
from tpu_raytracing_torch.trace.ray import Rays

# Stack entries pack (index << 3) | count, as the reference's 29/3-bit Node
# bitfields (src/Common.cuh:152-159).
_ENTRY_SHIFT = 3
_COUNT_MASK = 7
# Children a stack entry's node group holds at most: 2 in a binary tree, the
# one width any caller of the reference's tracers asks for.
_GROUP_WIDTH = 2

_F32_MAX = float(torch.finfo(torch.float32).max)

# Record-kernel launches (csrc/split_front.cu) since the count was last set to
# 0: reconstruct adds one where it launches the kernel and nowhere else.
launch_count = 0

# Node meta word: child << 5 | count << 2 | type.
_META_TYPE_MASK = 3
_META_COUNT_SHIFT = 2
_META_COUNT_MASK = 7
_META_CHILD_SHIFT = 5


@dataclasses.dataclass
class TraversalBVH:
    """Packed traversal view: one 32-byte row per node slot."""

    rows: torch.Tensor  # [N, 8] int32: min xyz, max xyz (bitcast f32), meta, pad
    root: torch.Tensor  # [] int32
    root_count: torch.Tensor  # [] int32


@dataclasses.dataclass
class PackedPairs:
    rows: torch.Tensor  # [P, 16] i32: v0..v3 xyz (bitcast), prim0, prim1, rot0, rot1


@dataclasses.dataclass
class TraceStats:
    box_tests: torch.Tensor  # [R] int32
    tri_tests: torch.Tensor  # [R] int32
    # [1] int32, nonzero when a ray's traversal stack overflowed: the
    # traversal stops that ray, and trace/split_trace.py:check_overflow
    # raises on the host.
    overflow: torch.Tensor


def f2i(a: torch.Tensor) -> torch.Tensor:
    """Bit-cast float32 -> int32 (``bitcast_convert_type``)."""
    return a.to(torch.float32).contiguous().view(torch.int32)


def i2f(a: torch.Tensor) -> torch.Tensor:
    """Bit-cast int32 -> float32."""
    return a.contiguous().view(torch.float32)


def pack_pairs(pairs: TrianglePairs) -> PackedPairs:
    rows = torch.cat(
        [
            f2i(pairs.v0),
            f2i(pairs.v1),
            f2i(pairs.v2),
            f2i(pairs.v3),
            pairs.prim_id_0.to(torch.int32)[:, None],
            pairs.prim_id_1.to(torch.int32)[:, None],
            pairs.rot_0.to(torch.int32)[:, None],
            pairs.rot_1.to(torch.int32)[:, None],
        ],
        dim=1,
    )
    return PackedPairs(rows=rows)


def pack_bvh(bvh: BVH) -> TraversalBVH:
    meta = ((bvh.child.to(torch.int64) << _META_CHILD_SHIFT)
            | (bvh.count.clamp(0, _META_COUNT_MASK).to(torch.int64) << _META_COUNT_SHIFT)
            | bvh.type.clamp(0, _META_TYPE_MASK).to(torch.int64)).to(torch.int32)
    rows = torch.cat([f2i(bvh.node_min), f2i(bvh.node_max), meta[:, None],
                      torch.zeros_like(meta)[:, None]], dim=1)
    return TraversalBVH(rows=rows, root=bvh.root, root_count=bvh.root_count)


def trace_rays(trav: TraversalBVH, pairs: PackedPairs, rays: Rays,
               active=None) -> Tuple[HitRecord, TraceStats]:
    """Closest-hit trace of a ray batch against the binary BVH.

    ``active`` ([R] bool) starts dead rays with an empty stack.
    """
    dev = rays.origin.device
    num = rays.origin.shape[0]
    num_slots = trav.rows.shape[0]
    num_pairs = pairs.rows.shape[0]
    stack_depth = STACK_DEPTH
    stack = torch.zeros((num, stack_depth), dtype=torch.int32, device=dev)
    stack[:, 0] = (trav.root.to(torch.int32) << _ENTRY_SHIFT) | trav.root_count.to(torch.int32)
    size = (torch.ones((num,), dtype=torch.int64, device=dev) if active is None
            else active.to(torch.int64))
    tmax = rays.tmax.clone()
    hit = torch.zeros((num,), dtype=torch.bool, device=dev)
    prim_id = torch.zeros((num,), dtype=torch.int32, device=dev)
    tri_id = torch.zeros((num,), dtype=torch.int32, device=dev)
    bary_u = torch.zeros((num,), dtype=torch.float32, device=dev)
    bary_v = torch.zeros((num,), dtype=torch.float32, device=dev)
    box_tests = torch.zeros((num,), dtype=torch.int32, device=dev)
    tri_tests = torch.zeros((num,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)

    while True:
        r = torch.nonzero(size > 0).reshape(-1)
        if r.numel() == 0:
            break
        sz = size[r] - 1
        entry = stack[r, sz]
        index = (entry >> _ENTRY_SHIFT).to(torch.int64)
        count = entry & _COUNT_MASK
        o, d, tmn = rays.origin[r], rays.direction[r], rays.tmin[r]
        tm, ht, pid, tid = tmax[r], hit[r], prim_id[r], tri_id[r]
        bu, bv, bt, tt = bary_u[r], bary_v[r], box_tests[r], tri_tests[r]
        have_buf = torch.zeros_like(ht)
        buf_entry = torch.zeros_like(entry)
        buf_dist = torch.zeros_like(tm)
        full = torch.zeros_like(ht)

        def push(mask, value, sz):
            nonlocal full
            over = mask & (sz >= stack_depth)
            full = full | over
            ok = mask & ~over
            stack[r[ok], sz[ok]] = value[ok]
            return sz + mask.to(torch.int64)

        for i in range(_GROUP_WIDTH):
            slot = (index + i).clamp(0, num_slots - 1)
            row = trav.rows[slot]
            meta = row[:, 6]
            child = meta >> _META_CHILD_SHIFT
            ccount = (meta >> _META_COUNT_SHIFT) & _META_COUNT_MASK
            ntype = meta & _META_TYPE_MASK
            valid = (i < count) & (ntype != CHILD_NONE)
            box_hit, dist = intersect_ray_aabb(i2f(row[:, 0:3]), i2f(row[:, 3:6]), o, d, tmn, tm)
            bt = bt + valid.to(torch.int32)

            # leaf: TrianglePair intersection (src/Tracer.cu:293-306)
            do_leaf = valid & box_hit & (ntype == CHILD_TRI)
            prow = pairs.rows[child.clamp(0, num_pairs - 1).to(torch.int64)]
            v0, v1, v2, v3 = (i2f(prow[:, 3 * k:3 * k + 3]) for k in range(4))
            tt = tt + do_leaf.to(torch.int32)
            acc, t_a, u_a, v_a = intersect_ray_triangle(v0, v1, v2, o, d, tmn, tm)
            take = do_leaf & acc
            tm = torch.where(take, t_a, tm)
            ht = ht | take
            pid = torch.where(take, prow[:, 12], pid)
            tid = torch.where(take, child << 1, tid)
            bu = torch.where(take, u_a, bu)
            bv = torch.where(take, v_a, bv)
            # the second triangle is tested when node.count > 0
            acc, t_b, u_b, v_b = intersect_ray_triangle(v2, v1, v3, o, d, tmn, tm)
            take = do_leaf & (ccount > 0) & acc
            tm = torch.where(take, t_b, tm)
            ht = ht | take
            pid = torch.where(take, prow[:, 13], pid)
            tid = torch.where(take, (child << 1) + 1, tid)
            bu = torch.where(take, u_b, bu)
            bv = torch.where(take, v_b, bv)

            # interior: near-child buffering (src/Tracer.cu:341-362)
            do_box = valid & box_hit & (ntype == CHILD_BOX)
            new_entry = (child << _ENTRY_SHIFT) | ccount
            first = do_box & ~have_buf
            buf_entry = torch.where(first, new_entry, buf_entry)
            buf_dist = torch.where(first, dist, buf_dist)
            second = do_box & have_buf
            closer = (dist < buf_dist) | ((dist == buf_dist)
                                          & (child > (buf_entry >> _ENTRY_SHIFT)))
            sz = push(second, torch.where(closer, buf_entry, new_entry), sz)
            buf_entry = torch.where(second & closer, new_entry, buf_entry)
            buf_dist = torch.where(second & closer, dist, buf_dist)
            have_buf = have_buf | do_box
        sz = push(have_buf, buf_entry, sz)

        size[r] = torch.where(full, 0, sz)
        overflow |= full.any().to(torch.int32)
        tmax[r], hit[r], prim_id[r], tri_id[r] = tm, ht, pid, tid
        bary_u[r], bary_v[r], box_tests[r], tri_tests[r] = bu, bv, bt, tt

    rec = HitRecord(hit=hit, t=tmax, prim_id=prim_id, tri_id=tri_id, bary_u=bary_u,
                    bary_v=bary_v)
    return rec, TraceStats(box_tests=box_tests, tri_tests=tri_tests, overflow=overflow)


def reconstruct_plain(pairs: PackedPairs, rays: Rays, t_flat, tri_flat,
                      any_hit: bool = False) -> HitRecord:
    """Full hit record from a tracer's winning (t, tri) per ray: one pair
    gather and one Möller-Trumbore per ray (wide_fat.py:_reconstruct). The
    record kernel's plain version (``reconstruct``).

    A closest hit also needs t < F32_MAX. A split or lane window none of
    whose triangles hits still names its last slot when the ray's t is
    F32_MAX (K1 and K5 keep that, bit-equal to the reference kernels); the
    reference calls it a hit at t = F32_MAX, this record a miss. An any-hit
    record (``any_hit``) carries ``rays.tmax`` as t, so it keeps tri >= 0
    as its hit."""
    hit = tri_flat >= 0
    if not any_hit:
        hit = hit & (t_flat < _F32_MAX)
    second = (tri_flat & 1).to(torch.bool)
    num_pairs = pairs.rows.shape[0]
    prow = pairs.rows[(tri_flat >> 1).clamp(0, num_pairs - 1).to(torch.int64)]
    v = i2f(prow[:, :12]).reshape(-1, 4, 3)
    v0, v1, v2, v3 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
    a = torch.where(second[:, None], v2, v0)
    c = torch.where(second[:, None], v3, v2)
    e1 = v1 - a
    e2 = c - a
    h = cross(rays.direction, e2)
    f = 1.0 / dot(e1, h)
    sv = rays.origin - a
    bu = f * dot(sv, h)
    bv = f * dot(rays.direction, cross(sv, e1))
    prim = torch.where(second, prow[:, 13], prow[:, 12])
    return HitRecord(
        hit=hit,
        t=torch.where(hit, t_flat, rays.tmax),
        prim_id=torch.where(hit, prim, 0),
        tri_id=torch.where(hit, tri_flat, 0),
        bary_u=torch.where(hit, bu, 0.0),
        bary_v=torch.where(hit, bv, 0.0),
    )


def check_kernel_operands(fn: str, specs) -> None:
    """Raises unless every (name, tensor, dtype, shape) of ``specs`` is a
    contiguous, 16-byte aligned tensor of that dtype and shape on the first
    one's device: what the split front's kernels (``csrc/split_front.cu``)
    take."""
    dev = specs[0][1].device
    for name, x, dtype, shape in specs:
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
                or not x.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
                f"{'' if x.is_contiguous() else ', not contiguous'}")
        if x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def check_record_operands(pairs: PackedPairs, rays: Rays, t_flat, tri_flat) -> None:
    """Raises unless ``reconstruct``'s operands are what the record kernel
    takes: pair rows [P >= 1, 16] int32, the rays' origin and direction
    [R, 3] and tmax [R] float32, t [R] float32 and tri [R] int32."""
    num = rays.origin.shape[0]
    check_kernel_operands("reconstruct", [
        ("rays.origin", rays.origin, torch.float32, (num, 3)),
        ("rays.direction", rays.direction, torch.float32, (num, 3)),
        ("rays.tmax", rays.tmax, torch.float32, (num,)),
        ("t", t_flat, torch.float32, (num,)),
        ("tri", tri_flat, torch.int32, (num,)),
        ("pairs.rows", pairs.rows, torch.int32, (max(pairs.rows.shape[0], 1), 16))])


_RECORD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def reconstruct(pairs: PackedPairs, rays: Rays, t_flat, tri_flat,
                any_hit: bool = False) -> HitRecord:
    """``reconstruct_plain``'s record (the same fields, values and dtypes).
    CPU tensors run ``reconstruct_plain``; CUDA tensors launch the record
    kernel (``csrc/split_front.cu``), one launch a call, or raise."""
    global launch_count
    dev = rays.origin.device
    if dev.type == "cpu":
        return reconstruct_plain(pairs, rays, t_flat, tri_flat, any_hit=any_hit)
    if dev.type != "cuda":
        raise ValueError(f"reconstruct: unsupported device {dev}")
    check_record_operands(pairs, rays, t_flat, tri_flat)
    num = rays.origin.shape[0]
    rec = HitRecord(hit=torch.empty((num,), dtype=torch.bool, device=dev),
                    t=torch.empty((num,), dtype=torch.float32, device=dev),
                    prim_id=torch.empty((num,), dtype=torch.int32, device=dev),
                    tri_id=torch.empty((num,), dtype=torch.int32, device=dev),
                    bary_u=torch.empty((num,), dtype=torch.float32, device=dev),
                    bary_v=torch.empty((num,), dtype=torch.float32, device=dev))
    if num == 0:
        return rec
    fn = _cuda_build.load_library("split_front").split_record_launch
    fn.argtypes = _RECORD_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(pairs.rows.data_ptr(), rays.origin.data_ptr(), rays.direction.data_ptr(),
             rays.tmax.data_ptr(), t_flat.data_ptr(), tri_flat.data_ptr(), rec.hit.data_ptr(),
             rec.t.data_ptr(), rec.prim_id.data_ptr(), rec.tri_id.data_ptr(),
             rec.bary_u.data_ptr(), rec.bary_v.data_ptr(), num, pairs.rows.shape[0],
             int(any_hit), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_record kernel launch failed: cudaError {err}")
    launch_count += 1
    return rec
