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

The app's instanced tracers (``make_instanced_tracers``, ``trace_instanced``;
closest-hit for the primary and bounce passes, any-hit for the shadow
passes) run the same scheme with no per-ray cap and no host read:

* ``inst.candidates``: the sweep (``sweep``; on the card one launch of
  ``csrc/instanced_sweep.cu``'s sweep kernel, one thread a ray, the
  instance boxes staged through shared memory) writes every overlap of
  every live ray, a ray's overlaps lowest instance first, into a fixed
  number of item slots, ``items_per_ray`` a ray; its plain version
  (``sweep_plain``) is ``candidate_masks`` and ``peel_candidates``. The
  slots past the last overlap keep key 0.
* ``inst.items``: the item keys (1 + instance << 3 | world octant) sorted,
  unused slots first, and each item's ray mapped into its instance's
  object space, as K1's operands (``items``).
* K1 over every slot (``split_trace.split_traverse``: its ``k1`` span),
  closest-hit or any-hit.
* ``inst.resolve``: each ray's winner (the smallest t, then the least hit
  id instance x 2P + triangle, P the BLAS's pair rows; a closest-hit
  record with the instance, ``InstancedHitRecord``) or its occlusion (an
  any-hit record: ``hit``, and ``t`` the ray's tmax), and the statistics
  (``resolve``, ``record``).

Overlaps past the slots are not traced: the call's ``TraceStats.overflow``
then carries ``split_trace.CANDIDATE_OVERFLOW``, and the frame's overflow
check (``split_trace.check_overflow``, at the read-back the frame already
has) raises ``InstancedCandidateOverflow``. Every value is the same on the
card and on the CPU; the sweep's item order is not (the card reserves
slots block by block), and no result depends on it. While
``timing.tracing()`` the counters ``inst.calls``, ``inst.rays`` (live
rays), ``inst.items`` (overlaps, before the slots' cap), ``inst.overflow``
(calls that overflowed) and ``inst.overlap_max`` (``timing.count_max``)
take each call's work.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_raytracing_torch.bvh.tlas import (
    instance_normal_maps,
    instance_world_aabbs,
    invert_affine,
)
from tpu_raytracing_torch.ops import _cuda_build
from tpu_raytracing_torch.trace import split_trace
from tpu_raytracing_torch.trace.brute import HitRecord, InstancedHitRecord
from tpu_raytracing_torch.trace.instanced import transform_rays
from tpu_raytracing_torch.trace.ray import Rays
from tpu_raytracing_torch.trace.traverse import (
    PackedPairs,
    TraceStats,
    check_kernel_operands,
    reconstruct,
    reconstruct_plain,
)
from tpu_raytracing_torch.utils import timing

_F32_MAX = float(torch.finfo(torch.float32).max)
_I64_MAX = int(torch.iinfo(torch.int64).max)
# an unused item slot's key (sorted first); a live one is 1 + (inst << 3 | octant)
_DEAD_KEY = 0
# the app's item slots a ray
ITEMS_PER_RAY = 4.0

# Sweep-kernel launches since the count was last set to 0: sweep adds one
# where it launches the kernel and nowhere else.
launch_count = 0
# Launches of the item, resolve and record kernels (csrc/instanced_sweep.cu)
# since each count was last set to 0: items, resolve and record each add one
# to their own where they launch their kernel.
items_launch_count = 0
resolve_launch_count = 0
record_launch_count = 0


@dataclasses.dataclass
class InstancedSplitAS:
    """Instances of one BLAS for the split kernel: ``views`` (K1's
    (inner, pairs, stack bound) of the BLAS), ``packed`` (its pair rows),
    the instances' world boxes ``wmin`` / ``wmax`` ([I, 3], all the "TLAS"
    the candidate sweep needs), ``inv_transforms`` ([I, 3, 4], object <-
    world) and ``normal_maps`` ([I, 3, 3], ``tlas.instance_normal_maps``:
    what ``path_trace`` shades an instance's hits with)."""

    views: tuple
    packed: PackedPairs
    wmin: torch.Tensor
    wmax: torch.Tensor
    inv_transforms: torch.Tensor
    normal_maps: Optional[torch.Tensor] = None


def build_instanced_split(views, packed: PackedPairs, blas_lo, blas_hi,
                          transforms: torch.Tensor) -> InstancedSplitAS:
    """A frame's instance structure: the world boxes of the BLAS box
    (``blas_lo`` / ``blas_hi``, [3]) under ``transforms`` ([I, 3, 4]),
    their inverses and their normal matrices. The BLAS itself is shared."""
    wmin, wmax = instance_world_aabbs(blas_lo, blas_hi, transforms)
    inv = invert_affine(transforms)
    return InstancedSplitAS(views=views, packed=packed, wmin=wmin, wmax=wmax,
                            inv_transforms=inv, normal_maps=instance_normal_maps(inv))


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
    the live items outnumbered its item_budget, or (the app's tracers) a
    call's overlaps outnumbered its item slots: hits would be dropped.
    Trace again with a larger k_slots, budget or ``items_per_ray``."""


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


# ---------------------------------------------------------------------------
# The app's instanced tracers: no per-ray cap, no host read
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Sweep:
    """The candidate sweep of one call of R rays into C item slots, and the
    per-ray state the resolve starts from.

    ``item_ray`` / ``item_key`` [C] int32: slot s holds an overlap (ray,
    1 + (instance << 3 | the ray's world-direction octant)); a ray's
    overlaps take consecutive slots, lowest instance first, from
    ``first[ray]``; slots past the call's overlaps keep key 0 (their ray is
    unset). ``nov`` [R] int32: each ray's overlaps, all of them. ``first``
    [R] int64 (or None): each ray's first slot. ``stats`` [4] int64: the
    call's overlaps, its live rays, its largest overlap, and (set by the
    resolve) 1 where the overlaps outnumbered the slots. ``best`` [R] int64
    (closest-hit: ``_I64_MAX``) or ``occluded`` [R] bool (any-hit: False),
    and ``box_tests`` / ``tri_tests`` [R] int32 (0): the resolve's
    accumulators."""

    item_ray: torch.Tensor
    item_key: torch.Tensor
    nov: torch.Tensor
    first: Optional[torch.Tensor]
    stats: torch.Tensor
    best: Optional[torch.Tensor]
    occluded: Optional[torch.Tensor]
    box_tests: torch.Tensor
    tri_tests: torch.Tensor


def _octants(direction: torch.Tensor) -> torch.Tensor:
    """[R] int32: bit a set where direction component a is above 0."""
    d = direction
    return ((d[:, 0] > 0).to(torch.int32) | ((d[:, 1] > 0).to(torch.int32) << 1)
            | ((d[:, 2] > 0).to(torch.int32) << 2))


def _state(num_r: int, any_hit: bool, dev):
    best = None if any_hit else torch.full((num_r,), _I64_MAX, dtype=torch.int64, device=dev)
    occ = torch.zeros((num_r,), dtype=torch.bool, device=dev) if any_hit else None
    zero = torch.zeros((num_r,), dtype=torch.int32, device=dev)
    return best, occ, zero, zero.clone()


def sweep_plain(wmin, wmax, rays: Rays, active, capacity: int, any_hit: bool,
                keep_first: bool = False) -> Sweep:
    """The sweep kernel's plain version: ``candidate_masks``, then every
    ray's overlaps peeled (``peel_candidates``) into consecutive slots in
    ray order, with one host read for the largest overlap."""
    num_r = rays.origin.shape[0]
    dev = rays.origin.device
    words, nov = candidate_masks(wmin, wmax, rays, active=active)
    top = int(nov.max()) if num_r else 0
    cands = peel_candidates(words, max(top, 1))
    taken = cands >= 0
    ray_of = torch.arange(num_r, dtype=torch.int32, device=dev)[:, None].expand_as(cands)[taken]
    key = 1 + ((cands[taken] << 3) | _octants(rays.direction)[ray_of.to(torch.int64)])
    total = int(ray_of.shape[0])
    n = min(total, capacity)
    item_ray = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    item_key = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    item_ray[:n] = ray_of[:n]
    item_key[:n] = key[:n]
    first = (torch.cumsum(nov, 0, dtype=torch.int64) - nov) if keep_first else None
    live = num_r if active is None else int(active.sum())
    stats = torch.tensor([total, live, top, 0], dtype=torch.int64, device=dev)
    return Sweep(item_ray, item_key, nov, first, stats, *_state(num_r, any_hit, dev))


def check_sweep_operands(wmin, wmax, rays: Rays, active) -> None:
    """Raises unless ``sweep``'s operands are what the sweep kernel takes:
    world boxes [I, 3], ray origins and directions [R, 3] and intervals [R]
    float32, ``active`` [R] bool or None."""
    num = rays.origin.shape[0]
    specs = [("rays.origin", rays.origin, torch.float32, (num, 3)),
             ("rays.direction", rays.direction, torch.float32, (num, 3)),
             ("rays.tmin", rays.tmin, torch.float32, (num,)),
             ("rays.tmax", rays.tmax, torch.float32, (num,)),
             ("wmin", wmin, torch.float32, (wmin.shape[0], 3)),
             ("wmax", wmax, torch.float32, (wmin.shape[0], 3))]
    if active is not None:
        specs.append(("active", active, torch.bool, (num,)))
    check_kernel_operands("sweep", specs)


_SWEEP_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                                   ctypes.c_void_p]


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def sweep(wmin, wmax, rays: Rays, active, capacity: int, any_hit: bool,
          keep_first: bool = False) -> Sweep:
    """Every overlap of every live ray with the instances' world boxes
    (``wmin`` / ``wmax`` [I, 3]), in ``capacity`` item slots (``Sweep``).
    CPU tensors run ``sweep_plain``; CUDA tensors launch the sweep kernel
    (``csrc/instanced_sweep.cu``), one launch a call, or raise."""
    global launch_count
    dev = rays.origin.device
    if dev.type == "cpu":
        return sweep_plain(wmin, wmax, rays, active, capacity, any_hit, keep_first)
    if dev.type != "cuda":
        raise ValueError(f"sweep: unsupported device {dev}")
    check_sweep_operands(wmin, wmax, rays, active)
    num_r, num_i = rays.origin.shape[0], wmin.shape[0]
    item_ray = torch.empty((capacity,), dtype=torch.int32, device=dev)
    item_key = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    nov = torch.empty((num_r,), dtype=torch.int32, device=dev)
    first = torch.empty((num_r,), dtype=torch.int64, device=dev) if keep_first else None
    stats = torch.zeros((4,), dtype=torch.int64, device=dev)
    best = None if any_hit else torch.empty((num_r,), dtype=torch.int64, device=dev)
    occ = torch.empty((num_r,), dtype=torch.bool, device=dev) if any_hit else None
    box = torch.empty((num_r,), dtype=torch.int32, device=dev)
    tri = torch.empty((num_r,), dtype=torch.int32, device=dev)
    out = Sweep(item_ray, item_key, nov, first, stats, best, occ, box, tri)
    if num_r == 0:
        return out
    fn = _cuda_build.load_library("instanced_sweep").inst_sweep_launch
    fn.argtypes = _SWEEP_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(rays.origin.data_ptr(), rays.direction.data_ptr(), rays.tmin.data_ptr(),
             rays.tmax.data_ptr(), _ptr(active), wmin.data_ptr(), wmax.data_ptr(),
             item_ray.data_ptr(), item_key.data_ptr(), nov.data_ptr(), _ptr(first),
             _ptr(best), _ptr(occ), box.data_ptr(), tri.data_ptr(), stats.data_ptr(),
             num_r, num_i, capacity, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instanced sweep kernel launch failed: cudaError {err}")
    launch_count += 1
    return out


def items_plain(inv_transforms, rays: Rays, s_key, order, item_ray):
    """The item kernel's plain version: for each sorted slot j (key
    ``s_key[j]``, from slot ``order[j]``), its ray mapped into its
    instance's object space (``transform_rays``) as K1 takes it
    (``split_trace.kernel_operands_plain``: the direction clamp, and an
    empty interval for an unused slot, which maps ray 0 by instance 0).
    Returns ((origin, direction, tmin, tmax) [C], slot ray [C] int32, -1
    for an unused slot)."""
    live = s_key != _DEAD_KEY
    ray = torch.where(live, item_ray[order], 0).to(torch.int64)
    inst = torch.where(live, (s_key - 1) >> 3, 0).to(torch.int64)
    o, d = transform_rays(inv_transforms[inst], rays.origin[ray], rays.direction[ray])
    ops = split_trace.kernel_operands_plain(
        Rays(origin=o, direction=d, tmin=rays.tmin[ray], tmax=rays.tmax[ray]), active=live)
    return ops, torch.where(live, ray, -1).to(torch.int32)


_ITEMS_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def items(inv_transforms, rays: Rays, sw: Sweep):
    """The sweep's items sorted by key (stable, unused slots first) and
    mapped into object space: (K1's operands (origin, direction, tmin,
    tmax) [C], slot ray [C] int32 (-1 unused), sorted keys [C] int32). CPU
    tensors run ``items_plain``; CUDA tensors launch the item kernel
    (``csrc/instanced_sweep.cu``) after the sort, or raise."""
    global items_launch_count
    s_key, order = torch.sort(sw.item_key, stable=True)
    dev = rays.origin.device
    if dev.type == "cpu":
        ops, s_ray = items_plain(inv_transforms, rays, s_key, order, sw.item_ray)
        return ops, s_ray, s_key
    if dev.type != "cuda":
        raise ValueError(f"items: unsupported device {dev}")
    num_c = s_key.shape[0]
    origin = torch.empty((num_c, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((num_c, 3), dtype=torch.float32, device=dev)
    tmin = torch.empty((num_c,), dtype=torch.float32, device=dev)
    tmax = torch.empty((num_c,), dtype=torch.float32, device=dev)
    s_ray = torch.empty((num_c,), dtype=torch.int32, device=dev)
    inv = inv_transforms.to(torch.float32).contiguous()
    fn = _cuda_build.load_library("instanced_sweep").inst_items_launch
    fn.argtypes = _ITEMS_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(s_key.data_ptr(), order.data_ptr(), sw.item_ray.data_ptr(),
             rays.origin.data_ptr(), rays.direction.data_ptr(), rays.tmin.data_ptr(),
             rays.tmax.data_ptr(), inv.data_ptr(), origin.data_ptr(), direction.data_ptr(),
             tmin.data_ptr(), tmax.data_ptr(), s_ray.data_ptr(), num_c, inv.shape[0],
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instanced item kernel launch failed: cudaError {err}")
    items_launch_count += 1
    return (origin, direction, tmin, tmax), s_ray, s_key


def _t_order(t: torch.Tensor) -> torch.Tensor:
    """int64 [N]: float32 t as a signed integer of the same order."""
    b = t.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def resolve_plain(sw: Sweep, s_ray, s_key, t, tri, ipops, lpops, k1_overflow, any_hit: bool,
                  width: int, tri_range: int, capacity: int):
    """The resolve kernel's plain version: each slot's K1 result folded
    into its ray. Closest-hit: ``best`` the least of (t, instance x
    ``tri_range`` + triangle) packed as int64 ((t's order << 32) | id);
    any-hit: ``occluded``. The statistics sum each slot's K1 work (``box
    tests = inner pops x width``, ``triangle tests = leaf pops x 2 x
    LEAFW``); ``sw.stats[3]`` is set, in place, to 1 where the overlaps
    outnumbered the slots, and ``TraceStats.overflow`` is K1's flag plus
    ``split_trace.CANDIDATE_OVERFLOW`` there. Returns (best or occluded,
    TraceStats); ``sw``'s per-ray state is left unchanged."""
    live = s_ray >= 0
    ray = s_ray[live].to(torch.int64)
    box = sw.box_tests.index_add(0, ray, ipops[live] * width)
    tris = sw.tri_tests.index_add(0, ray, lpops[live] * (2 * split_trace.LEAFW))
    over = (sw.stats[0] > capacity).to(torch.int64)
    sw.stats[3] = over
    overflow = (k1_overflow + over.to(torch.int32) * split_trace.CANDIDATE_OVERFLOW).reshape(1)
    stats = TraceStats(box_tests=box, tri_tests=tris, overflow=overflow.to(torch.int32))
    if any_hit:
        ok = live & (tri >= 0)
        occ = sw.occluded.clone()
        occ[s_ray[ok].to(torch.int64)] = True
        return occ, stats
    ok = live & (tri >= 0) & (t < _F32_MAX)
    inst = ((s_key - 1) >> 3).to(torch.int64)
    key = (_t_order(t) << 32) | (inst * tri_range + tri.to(torch.int64))
    best = sw.best.scatter_reduce(0, s_ray[ok].to(torch.int64), key[ok], "amin")
    return best, stats


_RESOLVE_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])


def resolve(sw: Sweep, s_ray, s_key, t, tri, ipops, lpops, k1_overflow, any_hit: bool,
            width: int, tri_range: int, capacity: int):
    """``resolve_plain``'s (best or occluded, TraceStats). CPU tensors run
    ``resolve_plain``; CUDA tensors launch the resolve kernel
    (``csrc/instanced_sweep.cu``: atomics into the sweep's per-ray state,
    which it updates in place), one launch a call, or raise."""
    global resolve_launch_count
    dev = s_ray.device
    if dev.type == "cpu":
        return resolve_plain(sw, s_ray, s_key, t, tri, ipops, lpops, k1_overflow, any_hit,
                             width, tri_range, capacity)
    if dev.type != "cuda":
        raise ValueError(f"resolve: unsupported device {dev}")
    overflow = torch.empty((1,), dtype=torch.int32, device=dev)
    fn = _cuda_build.load_library("instanced_sweep").inst_resolve_launch
    fn.argtypes = _RESOLVE_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(s_ray.data_ptr(), s_key.data_ptr(), t.data_ptr(), tri.data_ptr(),
             ipops.data_ptr(), lpops.data_ptr(), k1_overflow.data_ptr(), _ptr(sw.best),
             _ptr(sw.occluded), sw.box_tests.data_ptr(), sw.tri_tests.data_ptr(),
             sw.stats.data_ptr(), overflow.data_ptr(), s_ray.shape[0], capacity, width,
             2 * split_trace.LEAFW, tri_range, int(any_hit), split_trace.CANDIDATE_OVERFLOW,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instanced resolve kernel launch failed: cudaError {err}")
    resolve_launch_count += 1
    stats = TraceStats(box_tests=sw.box_tests, tri_tests=sw.tri_tests, overflow=overflow)
    return (sw.occluded if any_hit else sw.best), stats


def record_plain(pairs: PackedPairs, inv_transforms, rays: Rays, best,
                 tri_range: int) -> InstancedHitRecord:
    """The record kernel's plain version: each ray's winner from ``best``
    (``resolve``), its world ray mapped by the winner's instance
    (``transform_rays``, the direction as it is) and the hit record rebuilt
    there (``reconstruct_plain``); ``inst`` the winner's instance, -1 for
    none."""
    hit = best != _I64_MAX
    hi = best >> 32
    t = torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi).to(torch.int32).view(torch.float32)
    lo = best & 0xFFFFFFFF
    inst = torch.where(hit, lo // tri_range, 0)
    tri = torch.where(hit, lo % tri_range, -1).to(torch.int32)
    o, d = transform_rays(inv_transforms[inst], rays.origin, rays.direction)
    rec = reconstruct_plain(pairs, Rays(origin=o, direction=d, tmin=rays.tmin, tmax=rays.tmax),
                            torch.where(hit, t, rays.tmax), tri)
    return InstancedHitRecord(**{f.name: getattr(rec, f.name)
                                 for f in dataclasses.fields(HitRecord)},
                              inst=torch.where(hit, inst, -1).to(torch.int32))


_RECORD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def record(pairs: PackedPairs, inv_transforms, rays: Rays, best,
           tri_range: int) -> InstancedHitRecord:
    """``record_plain``'s record. CPU tensors run ``record_plain``; CUDA
    tensors launch the record kernel (``csrc/instanced_sweep.cu``), one
    launch a call, or raise."""
    global record_launch_count
    dev = rays.origin.device
    if dev.type == "cpu":
        return record_plain(pairs, inv_transforms, rays, best, tri_range)
    if dev.type != "cuda":
        raise ValueError(f"record: unsupported device {dev}")
    num = rays.origin.shape[0]
    check_kernel_operands("record", [
        ("best", best, torch.int64, (num,)),
        ("rays.origin", rays.origin, torch.float32, (num, 3)),
        ("rays.direction", rays.direction, torch.float32, (num, 3)),
        ("rays.tmax", rays.tmax, torch.float32, (num,)),
        ("pairs.rows", pairs.rows, torch.int32, (max(pairs.rows.shape[0], 1), 16))])
    rec = InstancedHitRecord(
        hit=torch.empty((num,), dtype=torch.bool, device=dev),
        t=torch.empty((num,), dtype=torch.float32, device=dev),
        prim_id=torch.empty((num,), dtype=torch.int32, device=dev),
        tri_id=torch.empty((num,), dtype=torch.int32, device=dev),
        bary_u=torch.empty((num,), dtype=torch.float32, device=dev),
        bary_v=torch.empty((num,), dtype=torch.float32, device=dev),
        inst=torch.empty((num,), dtype=torch.int32, device=dev))
    if num == 0:
        return rec
    inv = inv_transforms.to(torch.float32).contiguous()
    fn = _cuda_build.load_library("instanced_sweep").inst_record_launch
    fn.argtypes = _RECORD_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(best.data_ptr(), pairs.rows.data_ptr(), inv.data_ptr(), rays.origin.data_ptr(),
             rays.direction.data_ptr(), rays.tmax.data_ptr(), rec.hit.data_ptr(),
             rec.t.data_ptr(), rec.prim_id.data_ptr(), rec.tri_id.data_ptr(),
             rec.bary_u.data_ptr(), rec.bary_v.data_ptr(), rec.inst.data_ptr(), num,
             pairs.rows.shape[0], inv.shape[0], tri_range,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instanced record kernel launch failed: cudaError {err}")
    record_launch_count += 1
    return rec


def trace_instanced(ias: InstancedSplitAS, pairs: PackedPairs, rays: Rays, active=None,
                    any_hit: bool = False, items_per_ray: float = ITEMS_PER_RAY):
    """One instanced call (module docstring): closest hit
    (``InstancedHitRecord``) or, with ``any_hit``, occlusion (a
    ``HitRecord`` with ``hit``, ``t`` = ``rays.tmax`` and its triangle
    fields 0), and per-ray statistics. ``pairs`` are the BLAS's pair rows;
    the call holds ceil(``items_per_ray`` x R) item slots."""
    inner, _, stack_cap = ias.views
    num_r = rays.origin.shape[0]
    dev = rays.origin.device
    capacity = max(1, math.ceil(items_per_ray * num_r))
    tri_range = 2 * pairs.rows.shape[0]
    if ias.wmin.shape[0] * tri_range >= 1 << 32:
        raise ValueError(f"trace_instanced: {ias.wmin.shape[0]} instances of {tri_range // 2} "
                         "pair rows overflow the 32-bit hit id")
    with timing.span("inst.candidates"):
        sw = sweep(ias.wmin, ias.wmax, rays, active, capacity, any_hit)
    with timing.span("inst.items"):
        ops, s_ray, s_key = items(ias.inv_transforms, rays, sw)
    t, tri, ipops, lpops, k1_overflow = split_trace.split_traverse(
        inner, ias.views[1], *ops, leafw=split_trace.LEAFW, any_hit=any_hit,
        stack_cap=stack_cap)
    with timing.span("inst.resolve"):
        won, stats = resolve(sw, s_ray, s_key, t, tri, ipops, lpops, k1_overflow, any_hit,
                             inner.shape[1], tri_range, capacity)
        if any_hit:
            zi = torch.zeros((num_r,), dtype=torch.int32, device=dev)
            zf = torch.zeros((num_r,), dtype=torch.float32, device=dev)
            rec = HitRecord(hit=won, t=rays.tmax, prim_id=zi, tri_id=zi.clone(), bary_u=zf,
                            bary_v=zf.clone())
        else:
            rec = record(pairs, ias.inv_transforms, rays, won, tri_range)
    if timing.tracing():
        timing.count("inst.calls", 1)
        timing.count("inst.items", sw.stats[0])
        timing.count("inst.rays", sw.stats[1])
        timing.count_max("inst.overlap_max", sw.stats[2])
        timing.count("inst.overflow", sw.stats[3])
    return rec, stats


def make_instanced_tracers() -> dict:
    """The four tracers of a path-traced frame over an ``InstancedSplitAS``
    (``trace_instanced``), as ``path_trace`` keyword arguments: closest-hit
    for the primary and bounce passes, any-hit for both shadow passes. The
    items are sorted by instance and octant inside each call, so every pass
    takes the rays in the caller's order."""

    def closest(trav, pairs, rays, active=None):
        return trace_instanced(trav, pairs, rays, active, False)

    def occluded(trav, pairs, rays, active=None):
        return trace_instanced(trav, pairs, rays, active, True)

    return dict(tracer=closest, shadow_tracer=occluded, bounce_tracer=closest,
                shadow_tracer_bounce=occluded)
