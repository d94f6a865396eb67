"""A scene kind for the registry's tests, written into a copy of the
benchmark as ``rtbench/scenes/icospheres.py``: instances of one seeded
icosphere under uniform scales and translations, bobbing up and down with
the animation's time. The program traces them as world triangles through
its ordinary split path, rebuilt every step; the reference casts against
the instances with ``reference.InstancedCaster``."""

from __future__ import annotations

import math

import numpy as np
import torch

from rtbench import reference

BOB = 1.5  # the height of an instance's bob, in units of its scale


def icosphere(subdivisions: int, rng) -> np.ndarray:
    """[20 x 4^s, 3, 3] float32, wound outward; every vertex at a radius
    that varies smoothly with its direction, drawn from ``rng``."""
    g = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([(-1, g, 0), (1, g, 0), (-1, -g, 0), (1, -g, 0), (0, -1, g), (0, 1, g),
                  (0, -1, -g), (0, 1, -g), (g, 0, -1), (g, 0, 1), (-g, 0, -1), (-g, 0, 1)],
                 np.float64)
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
         (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
         (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    tris = v[np.asarray(f)]
    tris /= np.linalg.norm(tris, axis=-1, keepdims=True)
    for _ in range(subdivisions):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = ((p + q) / 2 for p, q in ((a, b), (b, c), (c, a)))
        ab, bc, ca = (m / np.linalg.norm(m, axis=-1, keepdims=True) for m in (ab, bc, ca))
        tris = np.stack([np.stack(t, 1) for t in ((a, ab, ca), (b, bc, ab), (c, ca, bc),
                                                  (ab, bc, ca))], 1).reshape(-1, 3, 3)
    k, phase = rng.normal(size=3) * 2.0, rng.uniform(0, 2 * math.pi)
    radius = 1.0 + 0.15 * np.sin(tris @ k + phase)
    return (tris * radius[..., None]).astype(np.float32)


def inputs(scene: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    obj = icosphere(scene["subdivisions"], rng)
    count = scene["instances"]
    angle = 2 * math.pi * (np.arange(count) + rng.uniform(0, 0.3, count)) / count
    ring = scene["ring"]
    out = dict(object=obj, scales=rng.uniform(0.8, 1.6, count).astype(np.float32),
               centres=np.stack([ring * np.cos(angle), rng.uniform(0, 2, count),
                                 ring * np.sin(angle)], 1).astype(np.float32),
               phases=rng.uniform(0, 2 * math.pi, count).astype(np.float32),
               material=scene["material"], light=scene["light"],
               counts=dict(num_triangles=count * obj.shape[0]))
    world = world_triangles(out, torch.as_tensor(transforms(out, None))).numpy()
    out["aabb"] = (world.reshape(-1, 3).min(0), world.reshape(-1, 3).max(0))
    return out


def transforms(inputs: dict, t) -> np.ndarray:
    """[I, 3, 4] float32 (world <- object) at time ``t`` (None: at rest)."""
    s = inputs["scales"]
    x = np.zeros((s.shape[0], 3, 4), np.float32)
    x[:, [0, 1, 2], [0, 1, 2]] = s[:, None]
    x[:, :, 3] = inputs["centres"]
    if t is not None:
        x[:, 1, 3] += BOB * s * np.sin(np.float32(t) + inputs["phases"])
    return x


def world_triangles(inputs: dict, x: torch.Tensor) -> torch.Tensor:
    """Every instance's triangles in world space, [I x T, 3, 3]."""
    obj = torch.as_tensor(inputs["object"], device=x.device)
    w = torch.einsum("iab,tvb->itva", x[:, :, :3], obj) + x[:, None, None, :, 3]
    return w.reshape(-1, 3, 3).contiguous()


class Program:
    def __init__(self, scene: dict, inputs: dict, argv: list, device):
        from tpu_raytracing_torch.app import main as app
        from tpu_raytracing_torch.scene import procedural
        from tpu_raytracing_torch.scene.types import Library, scene_to_device
        from tpu_raytracing_torch.utils.timing import StageTimer

        self.app, self.inputs, self.device = app, inputs, device
        self.timer = StageTimer
        self.args = app.parse_cmd(["--scene", f"soup:{inputs['counts']['num_triangles']}"]
                                  + argv)
        tris = self.world(None)
        lib = Library()
        lib.add_material("ball")
        lib.materials[-1].diffuse = np.asarray(scene["material"]["diffuse"], np.float32)
        lib.materials[-1].ambient = np.asarray(scene["material"]["ambient"], np.float32)
        host = procedural._finish(tris.cpu().numpy(), np.zeros(tris.shape[0], np.int32), lib,
                                  np.asarray(scene["light"], np.float32))
        self.dev_scene = scene_to_device(host, device)
        self.trav, self.packed, self.tracers = app.build_trav(self.args, tris,
                                                              timer=StageTimer())
        self.first = (self.trav, self.packed)

    def world(self, t) -> torch.Tensor:
        x = torch.as_tensor(transforms(self.inputs, t), device=self.device)
        return world_triangles(self.inputs, x)

    def step(self, t: float) -> float:
        timer = self.timer()
        self.trav, self.packed, _ = self.app.build_trav(self.args, self.world(t), timer=timer)
        return sum(ms for _, ms in timer.stages)

    def reseed(self) -> None:
        self.trav, self.packed = self.first


class Reference:
    def __init__(self, inputs: dict, device):
        self.inputs, self.device = inputs, device
        self.object = torch.as_tensor(inputs["object"], device=device)

    def transforms(self, t) -> torch.Tensor:
        return torch.as_tensor(transforms(self.inputs, t), device=self.device)

    def geometry(self, t, dtype=torch.float32):
        caster = reference.InstancedCaster(self.object, self.transforms(t), dtype)
        return caster, caster.normals
