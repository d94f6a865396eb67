"""Two-level (TLAS/BLAS) wavefront traversal.

Port of ``tpu_raytracing/trace/instanced.py`` (``trace_rays_instanced``).
It is ``trace/traverse.py:trace_rays`` with an instance word beside every
stack entry: entries tagged 0 trace in world space, entries tagged i + 1
trace instance i's BLAS with the ray mapped through the instance's inverse
transform. Hitting a ChildType_Inst leaf pushes the rebased BLAS root entry
tagged with that instance, in the same near-child order as a Box child. The
object-space direction is left unnormalised, so a hit's t stays a distance
along the world ray. Each step runs over the rays that still have work.

The reference clamps a push past ``STACK_DEPTH`` onto the top slot
(instanced.py:102-104), which loses a subtree without a word. Here such a
ray sets ``TraceStats.overflow`` and stops, and
``split_trace.check_overflow`` raises on the flag.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_raytracing_torch.bvh.sah import _fma
from tpu_raytracing_torch.bvh.tlas import InstancedAS
from tpu_raytracing_torch.bvh.types import CHILD_BOX, CHILD_INST, CHILD_NONE, CHILD_TRI, STACK_DEPTH
from tpu_raytracing_torch.ops.intersect import intersect_ray_aabb, intersect_ray_triangle
from tpu_raytracing_torch.trace.brute import HitRecord
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import (
    _COUNT_MASK,
    _ENTRY_SHIFT,
    _GROUP_WIDTH,
    _META_CHILD_SHIFT,
    _META_COUNT_MASK,
    _META_COUNT_SHIFT,
    _META_TYPE_MASK,
    PackedPairs,
    TraceStats,
    i2f,
)


def transform_rays(tf: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
                   fused: bool = False):
    """Origins and directions ([R, 3]) through per-ray affine maps
    ``tf`` ([R, 3, 4]): (M o + t, M d), each row summed left to right.
    With ``fused`` each row's sum rounds as XLA's CPU compiler contracts
    the reference's einsum outside a loop (``grid_instanced.py:150-153``):
    fma(m2, v2, fma(m1, v1, m0 v0)); inside ``instanced.py``'s while loop
    it does not."""
    def row_sum(v):
        if fused:
            return _fma(tf[:, :, 2], v[:, 2:3], _fma(tf[:, :, 1], v[:, 1:2],
                                                     tf[:, :, 0] * v[:, 0:1]))
        return tf[:, :, 0] * v[:, 0:1] + tf[:, :, 1] * v[:, 1:2] + tf[:, :, 2] * v[:, 2:3]

    return row_sum(origin) + tf[:, :, 3], row_sum(direction)


def trace_rays_instanced(inst_as: InstancedAS, pairs: PackedPairs,
                         rays: Rays) -> Tuple[HitRecord, torch.Tensor, TraceStats]:
    """Closest hit over the two-level structure. Returns (HitRecord,
    hit instance [R] int32 (-1: none), TraceStats)."""
    trav = inst_as.trav
    dev = rays.origin.device
    num = rays.origin.shape[0]
    num_slots = trav.rows.shape[0]
    num_pairs = pairs.rows.shape[0]
    depth = STACK_DEPTH
    stack = torch.zeros((num, depth), dtype=torch.int32, device=dev)
    stack_inst = torch.zeros((num, depth), dtype=torch.int32, device=dev)
    stack[:, 0] = (trav.root.to(torch.int32) << _ENTRY_SHIFT) | trav.root_count.to(torch.int32)
    size = torch.ones((num,), dtype=torch.int64, device=dev)
    tmax = rays.tmax.clone()
    hit = torch.zeros((num,), dtype=torch.bool, device=dev)
    prim_id = torch.zeros((num,), dtype=torch.int32, device=dev)
    tri_id = torch.zeros((num,), dtype=torch.int32, device=dev)
    inst_id = torch.full((num,), -1, dtype=torch.int32, device=dev)
    bary_u = torch.zeros((num,), dtype=torch.float32, device=dev)
    bary_v = torch.zeros((num,), dtype=torch.float32, device=dev)
    box_tests = torch.zeros((num,), dtype=torch.int32, device=dev)
    tri_tests = torch.zeros((num,), dtype=torch.int32, device=dev)
    overflow = torch.zeros((1,), dtype=torch.int32, device=dev)
    blas_entry = inst_as.blas_entry.to(torch.int32)

    while True:
        r = torch.nonzero(size > 0).reshape(-1)
        if r.numel() == 0:
            break
        sz = size[r] - 1
        entry = stack[r, sz]
        inst = stack_inst[r, sz]
        index = (entry >> _ENTRY_SHIFT).to(torch.int64)
        count = entry & _COUNT_MASK
        # the ray in the entry's instance's object space (row 0: identity)
        o, d = transform_rays(inst_as.inv_transforms[inst.to(torch.int64)], rays.origin[r],
                              rays.direction[r])
        tmn = rays.tmin[r]
        tm, ht, pid, tid, iid = tmax[r], hit[r], prim_id[r], tri_id[r], inst_id[r]
        bu, bv, bt, tt = bary_u[r], bary_v[r], box_tests[r], tri_tests[r]
        have_buf = torch.zeros_like(ht)
        buf_entry = torch.zeros_like(entry)
        buf_inst = torch.zeros_like(entry)
        buf_dist = torch.zeros_like(tm)
        full = torch.zeros_like(ht)

        def push(mask, value, value_inst, sz):
            nonlocal full
            over = mask & (sz >= depth)
            full = full | over
            ok = mask & ~over
            stack[r[ok], sz[ok]] = value[ok]
            stack_inst[r[ok], sz[ok]] = value_inst[ok]
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

            # a triangle leaf, in the entry's instance's object space
            do_leaf = valid & box_hit & (ntype == CHILD_TRI)
            prow = pairs.rows[child.clamp(0, num_pairs - 1).to(torch.int64)]
            v0, v1, v2, v3 = (i2f(prow[:, 3 * k:3 * k + 3]) for k in range(4))
            tt = tt + do_leaf.to(torch.int32)
            for a, b, c, col, second in ((v0, v1, v2, 12, 0), (v2, v1, v3, 13, 1)):
                acc, t, u, v = intersect_ray_triangle(a, b, c, o, d, tmn, tm)
                take = do_leaf & acc if second == 0 else do_leaf & (ccount > 0) & acc
                tm = torch.where(take, t, tm)
                ht = ht | take
                pid = torch.where(take, prow[:, col], pid)
                tid = torch.where(take, (child << 1) + second, tid)
                iid = torch.where(take, inst - 1, iid)
                bu = torch.where(take, u, bu)
                bv = torch.where(take, v, bv)

            # Box children and instance leaves both push, in near-child
            # order; an instance leaf pushes the BLAS root tagged with it
            is_inst = ntype == CHILD_INST
            do_push = valid & box_hit & ((ntype == CHILD_BOX) | is_inst)
            new_entry = torch.where(is_inst, blas_entry, (child << _ENTRY_SHIFT) | ccount)
            new_inst = torch.where(is_inst, child + 1, inst)
            first = do_push & ~have_buf
            buf_entry = torch.where(first, new_entry, buf_entry)
            buf_inst = torch.where(first, new_inst, buf_inst)
            buf_dist = torch.where(first, dist, buf_dist)
            second_hit = do_push & have_buf
            closer = (dist < buf_dist) | ((dist == buf_dist)
                                          & (child > (buf_entry >> _ENTRY_SHIFT)))
            sz = push(second_hit, torch.where(closer, buf_entry, new_entry),
                      torch.where(closer, buf_inst, new_inst), sz)
            buf_entry = torch.where(second_hit & closer, new_entry, buf_entry)
            buf_inst = torch.where(second_hit & closer, new_inst, buf_inst)
            buf_dist = torch.where(second_hit & closer, dist, buf_dist)
            have_buf = have_buf | do_push
        sz = push(have_buf, buf_entry, buf_inst, sz)

        size[r] = torch.where(full, 0, sz)
        overflow |= full.any().to(torch.int32)
        tmax[r], hit[r], prim_id[r], tri_id[r], inst_id[r] = tm, ht, pid, tid, iid
        bary_u[r], bary_v[r], box_tests[r], tri_tests[r] = bu, bv, bt, tt

    rec = HitRecord(hit=hit, t=tmax, prim_id=prim_id, tri_id=tri_id, bary_u=bary_u,
                    bary_v=bary_v)
    return rec, inst_id, TraceStats(box_tests=box_tests, tri_tests=tri_tests, overflow=overflow)
