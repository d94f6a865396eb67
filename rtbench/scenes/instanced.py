"""BASELINE config 4's instanced scene: copies of one seeded bumpy icosphere
on a floor grid, each under its own scale and turn, bobbing up and down and
turning with the animation's time. A configuration names it by this file's
name (``"scene": {"kind": "instanced", ...}``).

A scene kind (``harness.py``'s docstring) supplies the inputs both sides
are handed, the program's set-up, step and reseed through its app's own
functions, and the reference's geometry for the comparison. Here: the
object's triangles and every instance's placement, from which
``transforms`` makes a step's [I, 3, 4] transforms (world <- object); the
app's instanced path (``instance_blas``: the object's split tree, built
once; ``instance_level``: the instance level, rebuilt from each step's
transforms; ``make_instanced_tracers``), which never makes an instance's
world triangles; ``reference.InstancedCaster`` over the same object and
transforms.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtbench import reference


def icosphere(subdivisions: int, rng) -> np.ndarray:
    """[20 x 4^s, 3, 3] float32, wound outward; every vertex at a radius
    that varies smoothly with its direction, 1 +- 0.15, drawn from
    ``rng``."""
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
    """The host inputs of the configuration's ``scene`` from the run's
    seed: the object, each instance's grid point (jittered in x and z),
    scale, turn and phase, the world box the camera orbits (every
    instance's transformed object box at time 0), the material and light,
    and the counts the metric readers take."""
    rng = np.random.default_rng(seed)
    obj = icosphere(scene["subdivisions"], rng)
    cols, rows = scene["grid"]
    count = cols * rows
    k = np.arange(count)
    spacing, jitter = scene["spacing"], scene["jitter"]
    centres = np.stack([(k % cols - (cols - 1) / 2.0) * spacing,
                        np.zeros(count),
                        (k // cols - (rows - 1) / 2.0) * spacing], 1)
    centres[:, [0, 2]] += rng.uniform(-jitter, jitter, (count, 2))
    out = dict(object=obj, centres=centres, scales=rng.uniform(*scene["scale"], count),
               yaws=rng.uniform(0.0, 2 * math.pi, count),
               phases=rng.uniform(0.0, 2 * math.pi, count), bob=scene["bob"],
               turn=scene["turn"], material=scene["material"], light=scene["light"],
               counts=dict(num_triangles=int(obj.shape[0]), num_instances=count))
    flat = obj.reshape(-1, 3)
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)])
    box = np.where(corners == 0, flat.min(0), flat.max(0))  # [8, 3]
    x = transforms(out, 0.0).astype(np.float64)
    world = np.einsum("iab,kb->ika", x[:, :, :3], box) + x[:, None, :, 3]
    out["aabb"] = (world.reshape(-1, 3).min(0).astype(np.float32),
                   world.reshape(-1, 3).max(0).astype(np.float32))
    return out


def transforms(inputs: dict, t) -> np.ndarray:
    """[I, 3, 4] float32 (world <- object) at time ``t`` (None: 0): each
    instance scaled, turned about y by its turn plus ``turn`` x t, and
    lifted by ``bob`` x its scale x sin(t + its phase)."""
    t = 0.0 if t is None else float(t)
    s = inputs["scales"]
    yaw = inputs["yaws"] + inputs["turn"] * t
    c, sn = np.cos(yaw) * s, np.sin(yaw) * s
    x = np.zeros((s.shape[0], 3, 4), np.float64)
    x[:, 0, 0], x[:, 0, 2], x[:, 2, 0], x[:, 2, 2] = c, sn, -sn, c
    x[:, 1, 1] = s
    x[:, :, 3] = inputs["centres"]
    x[:, 1, 3] += inputs["bob"] * s * np.sin(t + inputs["phases"])
    return x.astype(np.float32)


class Program:
    """The program's side: the app's ``args`` from ``argv`` and the scene's
    own flags, the object's device scene, its split tree (built once), the
    first instance level (``trav``), the object's pair rows (``packed``) and
    the instanced tracers the app hands ``path_trace``."""

    def __init__(self, scene: dict, inputs: dict, argv: list, device):
        from tpu_raytracing_torch.app import main as app

        # the app's instanced path: a program without it stops here
        self.blas_fn, self.level_fn = app.instance_blas, app.instance_level
        tracers_fn = app.make_instanced_tracers
        from tpu_raytracing_torch.scene import procedural
        from tpu_raytracing_torch.scene.types import Library, scene_to_device

        obj = inputs["object"]
        self.inputs, self.device = inputs, device
        argv = ["--scene", f"soup:{obj.shape[0]}"] + argv + [
            "--instances", str(inputs["counts"]["num_instances"])]
        if scene["pairs"]:
            argv.append("--pairs")
        self.args = args = app.parse_cmd(argv)
        lib = Library()
        lib.add_material("ball")
        lib.materials[-1].diffuse = np.asarray(scene["material"]["diffuse"], np.float32)
        lib.materials[-1].ambient = np.asarray(scene["material"]["ambient"], np.float32)
        host = procedural._finish(obj, np.zeros(obj.shape[0], np.int32), lib,
                                  np.asarray(scene["light"], np.float32))
        self.dev_scene = scene_to_device(host, device)
        self.blas = self.blas_fn(args, torch.as_tensor(obj, device=device))
        self.packed = self.blas.packed
        self.trav = self.first = self.level(None)
        self.tracers = tracers_fn()

    def level(self, t):
        """The app's instance level at time ``t``."""
        x = torch.as_tensor(transforms(self.inputs, t), device=self.device)
        return self.level_fn(self.blas, x)

    def step(self, t: float) -> float:
        """The instance level of an animated step at time ``t`` from the
        moved transforms (the object's tree stays). Returns its build time
        in ms, the transforms' copy to the device included."""
        from tpu_raytracing_torch.utils.timing import StageTimer

        timer = StageTimer()
        self.trav = timer.run("InstanceLevel", self.level, t)
        return sum(ms for _, ms in timer.stages)

    def reseed(self) -> None:
        """Back to set-up's instance level."""
        self.trav = self.first


class Reference:
    """The reference's side: every ray against every triangle of every
    instance whose box its interval meets (``reference.InstancedCaster``)
    at a capture's time; hit ids instance x T + triangle and their
    normals."""

    def __init__(self, inputs: dict, device):
        self.inputs, self.device = inputs, device
        self.object = torch.as_tensor(inputs["object"], device=device)

    def geometry(self, t, dtype=torch.float32):
        """(caster, normals) of the capture at time ``t``."""
        x = torch.as_tensor(transforms(self.inputs, t), device=self.device)
        caster = reference.InstancedCaster(self.object, x, dtype)
        return caster, caster.normals
