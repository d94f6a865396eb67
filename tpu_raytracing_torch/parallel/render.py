"""Multi-device rendering on ``torch.distributed``: one process a row band.

Port of ``tpu_raytracing/parallel/render.py`` (``make_mesh``,
``render_frame_sharded``, ``render_frame_auto_sharded``). The reference
maps a function over the row bands of a JAX device mesh with
``shard_map``; here each process of a ``torch.distributed`` group is one
band. The acceleration structure, scene and camera are replicated (every
rank builds or receives the same ones); each rank traces and shades its
own band; the box-test counter is summed with ``all_reduce`` and the
image is gathered onto every rank with ``all_gather``, so every rank
returns what the reference's caller gets.

``Mesh`` is the group's handle: its process group, rank, world size,
backend and the rank's device. Without an initialised group it is a world
of one. ``init_mesh`` starts a group: NCCL for CUDA devices, gloo for the
CPU, unless the caller names the backend. NCCL refuses two ranks on one
device, so ranks that share a card use gloo; gloo's collectives are then
fed host copies, made here explicitly (``_collective_in``), and the result
is copied back to the rank's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tpu_raytracing_torch.scene.types import DeviceScene
from tpu_raytracing_torch.trace.modes import RenderType
from tpu_raytracing_torch.trace.ray import Rays, generate_primary_rays, ray_spread
from tpu_raytracing_torch.trace.render import shade_rays
from tpu_raytracing_torch.trace.traverse import PackedPairs, TraceStats, trace_rays


@dataclasses.dataclass
class Mesh:
    """One rank's view of the group that shards the ray/pixel axis."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None  # a torch.distributed ProcessGroup; None = the default
    backend: Optional[str] = None  # None for a world of one without a group

    def band(self, num: int) -> slice:
        """This rank's slice of ``num`` items split into equal bands."""
        if num % self.size:
            raise ValueError(f"{num} items do not split into {self.size} equal bands")
        per = num // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def _device(device) -> torch.device:
    """``device`` as a torch.device, a CUDA device with its index (default:
    the current CUDA device)."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(device=None, group=None) -> Mesh:
    """The handle of the current process in ``group`` (default: the
    initialised default group; a world of one if none is initialised).
    ``device`` defaults to the current CUDA device."""
    device = _device(device)
    if not dist.is_available() or not dist.is_initialized():
        return Mesh(rank=0, size=1, device=device)
    return Mesh(rank=dist.get_rank(group), size=dist.get_world_size(group), device=device,
                group=group, backend=dist.get_backend(group))


def init_mesh(rank: int, world_size: int, init_method: str, device=None,
              backend: Optional[str] = None) -> Mesh:
    """Start the default process group (``init_method`` such as
    ``tcp://localhost:PORT``) and return this rank's ``Mesh``. The backend
    defaults to NCCL on a CUDA device and gloo on the CPU."""
    device = _device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return make_mesh(device)


def _collective_in(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor a collective is given: a host copy for gloo on a CUDA
    device (explicit, not left to the backend), bools as uint8."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if mesh.backend == "gloo" and x.device.type != "cpu":
        x = x.cpu()
    return x.contiguous()


def _collective_out(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype)


def all_reduce(mesh: Mesh, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the group (``op`` "sum" or "max"), on every rank."""
    if mesh.backend is None:
        return x
    buf = _collective_in(mesh, x).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=mesh.group)
    return _collective_out(buf, x)


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order, on every
    rank; the bands must have one shape."""
    if mesh.backend is None:
        return x
    buf = _collective_in(mesh, x)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return _collective_out(torch.cat(parts), x)


def gather_fields(mesh: Mesh, obj):
    """``all_gather`` of every tensor field of a dataclass; a
    ``TraceStats`` overflow flag is summed instead."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if not isinstance(v, torch.Tensor):
            continue
        if isinstance(obj, TraceStats) and f.name == "overflow":
            out[f.name] = all_reduce(mesh, v)
        else:
            out[f.name] = all_gather(mesh, v)
    return dataclasses.replace(obj, **out)


def band_rays(mesh: Mesh, rays: Rays) -> Rays:
    """This rank's band of a ray batch."""
    sl = mesh.band(rays.origin.shape[0])
    return Rays(*(getattr(rays, f)[sl] for f in ("origin", "direction", "tmin", "tmax")))


def render_frame_sharded(
    mesh: Mesh,
    trav,
    pairs: PackedPairs,
    scene: DeviceScene,
    camera: dict,
    width: int,
    height: int,
    render_type: RenderType = RenderType.DEPTH,
    tracer=trace_rays,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render one frame with pixel rows split into equal bands over the
    group (``height`` must divide by its size): rays for the whole frame,
    then each rank traces and shades its band with ``tracer`` (the
    reference's default, ``trace_rays``). Returns the full [H, W, 4] uint8
    image and the group's box-test total, on every rank."""
    if height % mesh.size:
        raise ValueError(f"height {height} does not divide by the group size {mesh.size}")
    rays = band_rays(mesh, generate_primary_rays(camera, width, height))
    img, tests = shade_rays(trav, pairs, scene, camera, rays, ray_spread(width), render_type,
                            tracer)
    return all_gather(mesh, img).reshape(height, width, 4), all_reduce(mesh, tests)


def render_frame_auto_sharded(
    mesh: Mesh,
    trav,
    pairs: PackedPairs,
    scene: DeviceScene,
    camera: dict,
    width: int,
    height: int,
    render_type: RenderType = RenderType.DEPTH,
):
    """``render_frame`` with the image banded over the group. The
    reference leaves the banding to XLA's partitioner; the function is
    ``render_frame_sharded``'s, which this calls."""
    return render_frame_sharded(mesh, trav, pairs, scene, camera, width, height, render_type)
