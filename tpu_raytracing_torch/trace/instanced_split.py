"""Instances sharing one BLAS, traced by K1 in one object-space pass.

Port of ``tpu_raytracing/trace/instanced_split.py``
(``InstancedSplitAS``, ``build_instanced_split``, ``_sanitize_dir``,
``candidate_masks``, ``peel_candidates``, ``InstancedCandidateOverflow``,
``max_overlap``, ``trace_rays_instanced_split``,
``check_candidate_capacity``).

* Candidates: one slab sweep over the instances' world boxes, in chunks of
  instances, reduced straight to per-ray bitmask words ([R, ceil(I/32)]),
  then the ``k_slots`` lowest set bits of each ray are peeled with
  [R, W]-wide word operations. Every candidate is traced and the closest
  hit taken, so their order does not matter.
* One object-space pass: every instance shares the BLAS, so a (ray,
  instance) item mapped through the instance's inverse transform traces
  like a ray of a one-level scene. The items are sorted by (live,
  instance, world-direction octant), mapped, and traced by K1 in one call
  (``split_trace.trace_rays_split(..., raw=True)``); the directions stay
  unnormalised, so t is a distance along the world ray. Each ray's winner
  is the smallest t over its items, the first item on a tie (two
  scatter-mins keyed by the sorted ray ids), and one reconstruction gives
  its record.

Statistics are K1's per item, summed per ray over the ray's live items.
The reference adds every item's, so its dead and padding items (ray 0's
in the budgeted path) land on ray 0 (instanced_split.py:299-302); here
only live items count. The reference's ``k`` and ``c_slots`` schedule TPU
packets and have no counterpart here: K1 takes the items as they come,
unpadded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_raytracing_torch.bvh.tlas import instance_world_aabbs, invert_affine
from tpu_raytracing_torch.trace import split_trace
from tpu_raytracing_torch.trace.brute import HitRecord
from tpu_raytracing_torch.trace.instanced import transform_rays
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import PackedPairs, TraceStats, reconstruct

_F32_MAX = float(torch.finfo(torch.float32).max)


@dataclasses.dataclass
class InstancedSplitAS:
    """Instances of one BLAS for the split kernel: ``views`` (K1's
    (inner, pairs, stack bound) of the BLAS), ``packed`` (its pair rows),
    the instances' world boxes ``wmin`` / ``wmax`` ([I, 3], all the "TLAS"
    the candidate sweep needs) and ``inv_transforms`` ([I, 3, 4], object <-
    world)."""

    views: tuple
    packed: PackedPairs
    wmin: torch.Tensor
    wmax: torch.Tensor
    inv_transforms: torch.Tensor


def build_instanced_split(views, packed: PackedPairs, blas_lo, blas_hi,
                          transforms: torch.Tensor) -> InstancedSplitAS:
    """A frame's instance structure: the world boxes of the BLAS box
    (``blas_lo`` / ``blas_hi``, [3]) under ``transforms`` ([I, 3, 4]) and
    their inverses. The BLAS itself is shared."""
    wmin, wmax = instance_world_aabbs(blas_lo, blas_hi, transforms)
    return InstancedSplitAS(views=views, packed=packed, wmin=wmin, wmax=wmax,
                            inv_transforms=invert_affine(transforms))


def _sanitize_dir(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() < 1e-30, torch.where(d < 0, -1e-30, 1e-30), d)


def candidate_masks(wmin, wmax, rays: Rays, active=None, chunk: int = 256):
    """Per-ray instance hit bitmasks and overlap counts: (words [R,
    ceil(I/32)] int64 holding uint32 values, bit i of word w set when the
    ray's interval meets instance 32 w + i's world box; nov [R] int32).
    ``chunk`` instances are tested at a time; dead rays (``active`` False)
    meet no box."""
    num_i = wmin.shape[0]
    nw = -(-num_i // 32)
    inv = 1.0 / _sanitize_dir(rays.direction)
    o = rays.origin
    tmin, tmax = rays.tmin, rays.tmax
    if active is not None:
        tmin = torch.where(active, tmin, _F32_MAX)
        tmax = torch.where(active, tmax, -_F32_MAX)
    num_r = o.shape[0]
    words = []
    nov = torch.zeros((num_r,), dtype=torch.int32, device=o.device)
    for c0 in range(0, num_i, chunk):
        c1 = min(c0 + chunk, num_i)
        front = back = None
        for a in range(3):
            t0 = (wmin[None, c0:c1, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
            t1 = (wmax[None, c0:c1, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            front = lo if front is None else torch.maximum(front, lo)
            back = hi if back is None else torch.minimum(back, hi)
        hitm = (back >= front) & (front <= tmax[:, None]) & (back >= tmin[:, None])
        nov += hitm.sum(dim=1, dtype=torch.int32)
        pad = (-(c1 - c0)) % 32
        if pad:
            hitm = torch.nn.functional.pad(hitm, (0, pad))
        bits = torch.arange(32, dtype=torch.int64, device=o.device)
        words.append((hitm.reshape(num_r, -1, 32).to(torch.int64) << bits).sum(dim=2))
    return torch.cat(words, dim=1)[:, :nw], nov


def peel_candidates(words: torch.Tensor, k_slots: int) -> torch.Tensor:
    """The ``k_slots`` lowest set instance bits of each ray, lowest first:
    [R, K] int32, -1 past the ray's last."""
    num_r, nw = words.shape
    words = words.clone()
    widx = torch.arange(nw, dtype=torch.int64, device=words.device)[None, :]
    rows = torch.arange(num_r, device=words.device)
    cands = []
    for _ in range(k_slots):
        nz = words != 0
        any_nz = nz.any(dim=1)
        wi = torch.where(nz, widx, nw).amin(dim=1).clamp(max=nw - 1)
        wv = words[rows, wi]
        bit = wv & -wv  # the lowest set bit
        bidx = torch.log2(bit.clamp(min=1).to(torch.float64)).round().to(torch.int64)
        cands.append(torch.where(any_nz, wi * 32 + bidx, -1))
        words[rows, wi] = wv & ~bit
    return torch.stack(cands, dim=1).to(torch.int32)


class InstancedCandidateOverflow(RuntimeError):
    """A ray overlapped more instance boxes than the tracer's k_slots, or
    the live items outnumbered its item_budget: hits would be dropped.
    Trace again with a larger k_slots or budget."""


def max_overlap(ias: InstancedSplitAS, rays: Rays) -> int:
    """The largest per-ray instance overlap (sizes k_slots): one sweep and
    one host read."""
    _, nov = candidate_masks(ias.wmin, ias.wmax, rays)
    return int(nov.max())


def trace_rays_instanced_split(
    ias: InstancedSplitAS, rays: Rays, active=None, k_slots: int = 8,
    item_budget: Optional[int] = None,
) -> Tuple[HitRecord, torch.Tensor, TraceStats, torch.Tensor]:
    """Closest hit over instances sharing one BLAS (module docstring).

    Returns (HitRecord, hit instance [R] int32 (-1: none), TraceStats,
    guard [2] int32 = (largest per-ray overlap, live items)), the guard
    for ``check_candidate_capacity`` against (k_slots, item_budget).

    With ``item_budget`` None the items are the full [R * k_slots]
    expansion. A budget compacts the live items into ``item_budget`` slots
    (a ray's live candidates are its first nov_k slots, so item (r, j)
    goes to base[r] + j, base the exclusive prefix sum of nov_k); live
    items past the budget are dropped, which the guard reports.
    """
    dev = rays.origin.device
    num_r = rays.origin.shape[0]
    words, nov = candidate_masks(ias.wmin, ias.wmax, rays, active=active)
    cand_i = peel_candidates(words, k_slots)
    nov_k = nov.clamp(max=k_slots)
    total_live = nov_k.sum().to(torch.int32)
    rsrc = torch.arange(num_r, dtype=torch.int32, device=dev)[:, None].expand(num_r, k_slots)
    if item_budget is None:
        inst = cand_i.reshape(-1)
        ray_id = rsrc.reshape(-1)
    else:
        base = torch.cumsum(nov_k, 0, dtype=torch.int32) - nov_k
        slot = torch.arange(k_slots, dtype=torch.int32, device=dev)[None, :]
        dest = torch.where(slot < nov_k[:, None], base[:, None] + slot, item_budget).reshape(-1)
        keep = dest < item_budget
        inst = torch.full((item_budget,), -1, dtype=torch.int32, device=dev)
        ray_id = torch.zeros((item_budget,), dtype=torch.int32, device=dev)
        inst[dest[keep].to(torch.int64)] = cand_i.reshape(-1)[keep]
        ray_id[dest[keep].to(torch.int64)] = rsrc.reshape(-1)[keep]
    live = inst >= 0
    # world-direction octant: within one instance the world -> object map is
    # one affine, so world octants split directions as object octants do
    d_w = rays.direction
    woct = ((d_w[:, 0] > 0).to(torch.int32) | ((d_w[:, 1] > 0).to(torch.int32) << 1)
            | ((d_w[:, 2] > 0).to(torch.int32) << 2))
    ray_id = ray_id.to(torch.int64)
    key = ((~live).to(torch.int32) << 30) | (inst.clamp(min=0) << 3) | woct[ray_id]
    s_key, order = torch.sort(key, stable=True)
    s_inst = inst.clamp(min=0)[order].to(torch.int64)
    s_ray = ray_id[order]
    act = (s_key >> 30) == 0

    o_obj, d_obj = transform_rays(ias.inv_transforms[s_inst], rays.origin[s_ray],
                                  rays.direction[s_ray])
    srt = Rays(origin=o_obj, direction=d_obj, tmin=rays.tmin[s_ray], tmax=rays.tmax[s_ray])
    (t_it, tri_it), stats = split_trace.trace_rays_split(
        ias.views, ias.packed, srt, active=act, raw=True)

    # each ray's winner: the smallest t, then the first item with it
    nitems = s_ray.shape[0]
    ok = act & (tri_it >= 0)
    tt = torch.where(ok, t_it, _F32_MAX)
    tbest = torch.full((num_r,), _F32_MAX, dtype=torch.float32, device=dev).scatter_reduce(
        0, s_ray, tt, reduce="amin")
    hit = tbest < _F32_MAX
    iota = torch.arange(nitems, dtype=torch.int64, device=dev)
    win_pos = torch.full((num_r,), nitems, dtype=torch.int64, device=dev).scatter_reduce(
        0, s_ray, torch.where(ok & (tt == tbest[s_ray]), iota, nitems), reduce="amin")
    wp = win_pos.clamp(max=nitems - 1)
    o_w, d_wo = transform_rays(ias.inv_transforms[s_inst[wp]], rays.origin[s_ray[wp]],
                               rays.direction[s_ray[wp]])
    rec = reconstruct(ias.packed, Rays(origin=o_w, direction=d_wo, tmin=rays.tmin,
                                       tmax=rays.tmax),
                      torch.where(hit, tbest, rays.tmax), torch.where(hit, tri_it[wp], -1))
    inst_out = torch.where(hit, s_inst[wp], -1).to(torch.int32)

    # per-ray statistics over the live items only
    zero = torch.zeros((num_r,), dtype=torch.int32, device=dev)
    bt = zero.index_add(0, s_ray, torch.where(act, stats.box_tests, 0))
    trt = zero.index_add(0, s_ray, torch.where(act, stats.tri_tests, 0))
    guard = torch.stack([nov.max(), total_live]).to(torch.int32)
    return rec, inst_out, TraceStats(box_tests=bt, tri_tests=trt,
                                     overflow=stats.overflow), guard


def check_candidate_capacity(guard, k_slots: int, item_budget: Optional[int] = None) -> None:
    """Host check of a trace's guard: raises InstancedCandidateOverflow
    when a ray overlapped more instances than ``k_slots`` or the live items
    outnumbered ``item_budget`` (hits would be dropped either way)."""
    g = np.asarray(guard.cpu() if isinstance(guard, torch.Tensor) else guard).reshape(-1)
    mo = int(g[0])
    if mo > k_slots:
        raise InstancedCandidateOverflow(
            f"instance overlap {mo} exceeds k_slots {k_slots}; re-trace with k_slots >= {mo}")
    if item_budget is not None and len(g) > 1 and int(g[1]) > item_budget:
        raise InstancedCandidateOverflow(
            f"live items {int(g[1])} exceed item_budget {item_budget}; re-trace with a "
            f"larger budget")
