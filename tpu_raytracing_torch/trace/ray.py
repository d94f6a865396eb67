"""Camera ray generation (reference: src/Tracer.cu:475-494).

Port of ``tpu_raytracing/trace/ray.py`` (``Rays``, ``PRIMARY_TMIN``,
``generate_primary_rays``, ``ray_spread``): rays for the whole frame are one
dense [H*W] batch on the camera tensors' device.
"""

from __future__ import annotations

import dataclasses

import torch

# Primary-ray tmin (reference: src/Tracer.cu:493).
PRIMARY_TMIN = 1e-5


@dataclasses.dataclass
class Rays:
    origin: torch.Tensor  # [R, 3] float32
    direction: torch.Tensor  # [R, 3] float32
    tmin: torch.Tensor  # [R] float32
    tmax: torch.Tensor  # [R] float32

    def take(self, idx: torch.Tensor) -> "Rays":
        """Rays gathered (permuted or sliced) by ``idx``."""
        return Rays(self.origin[idx], self.direction[idx], self.tmin[idx],
                    self.tmax[idx])


def generate_primary_rays(camera: dict, width: int, height: int) -> Rays:
    """One ray per pixel, row-major (pixel (x, y) -> ray y*width + x),
    through the pixel centre: p = ndc.x*u + ndc.y*v + w, normalised."""
    dev = camera["position"].device
    x = torch.arange(width, dtype=torch.float32, device=dev)
    y = torch.arange(height, dtype=torch.float32, device=dev)
    ndc_x = 2.0 * ((x + 0.5) / width) - 1.0
    ndc_y = 2.0 * ((y + 0.5) / height) - 1.0
    gy, gx = torch.meshgrid(ndc_y, ndc_x, indexing="ij")  # [H, W]
    p = (
        gx[..., None] * camera["u"][None, None, :]
        + gy[..., None] * camera["v"][None, None, :]
        + camera["w"][None, None, :]
    )
    direction = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    direction = direction.reshape(-1, 3).to(torch.float32)
    num = width * height
    origin = camera["position"][None, :].expand(num, 3).to(torch.float32).contiguous()
    tmin = torch.full((num,), PRIMARY_TMIN, dtype=torch.float32, device=dev)
    tmax = camera["max_depth"].to(torch.float32).expand(num).contiguous()
    return Rays(origin=origin, direction=direction, tmin=tmin, tmax=tmax)


def ray_spread(width: int) -> float:
    """Footprint spread for ray-differential LOD (src/Tracer.cu:486)."""
    return 2.0 / width
