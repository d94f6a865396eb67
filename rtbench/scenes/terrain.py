"""The terrain: BASELINE config 5's tessellated heightfield, its height
noise drawn from the seed. A configuration names it by this file's name
(``"scene": {"kind": "terrain", ...}``).

A scene kind (``harness.py``'s docstring) supplies the inputs both sides
are handed, the program's set-up, step and reseed through its app's own
functions, and the reference's geometry for the comparison. Here: the
terrain's triangles, its material and light; the app's split, SAH or
Karras structures over them, rebuilt or refitted by ``animated_trees``
where the traffic animates; every ray against every triangle of the rest
pose wobbled to a capture's time, shaded with the rest pose's normals.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench import reference


def terrain_triangles(num_triangles: int, extent: float, height: float,
                      seed: int) -> np.ndarray:
    """[T, 3, 3] float32: a tessellated heightfield of about
    ``num_triangles`` triangles, two to a grid quad sharing its diagonal
    (2t, 2t+1), its height noise drawn from ``seed``. The heights are
    ``procedural.terrain``'s; each triangle is wound so that its flat
    normal, cross(v1 - v0, v2 - v1), faces up (+y), toward the light above
    the scene (``procedural.terrain`` winds them facing down)."""
    n = max(int(np.sqrt(num_triangles / 2)), 2)
    xs = np.linspace(-extent / 2, extent / 2, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs)
    rng = np.random.default_rng(seed)
    gy = (height * np.sin(gx * 0.11) * np.cos(gz * 0.13)
          + 0.3 * height * np.sin(gx * 0.71 + 1.3) * np.sin(gz * 0.53)
          + rng.normal(0, 0.05 * height, gx.shape)).astype(np.float32)
    verts = np.stack([gx, gy, gz], axis=-1)
    v00 = verts[:-1, :-1].reshape(-1, 3)
    v01 = verts[:-1, 1:].reshape(-1, 3)
    v10 = verts[1:, :-1].reshape(-1, 3)
    v11 = verts[1:, 1:].reshape(-1, 3)
    upper = np.stack([v00, v11, v01], axis=1)
    lower = np.stack([v00, v10, v11], axis=1)
    return np.stack([upper, lower], axis=1).reshape(-1, 3, 3).astype(np.float32)


def inputs(scene: dict, seed: int) -> dict:
    """The host inputs of the configuration's ``scene`` from the run's
    seed: the triangles, the world box the camera orbits, the material and
    light both sides shade with, and the counts the metric readers take."""
    tris = terrain_triangles(scene["triangles"], scene["extent"], scene["height"], seed)
    flat = tris.reshape(-1, 3)
    return dict(triangles=tris, aabb=(flat.min(0), flat.max(0)), material=scene["material"],
                light=scene["light"], counts=dict(num_triangles=int(tris.shape[0])))


class Program:
    """The program's side: the app's ``args`` from ``argv`` and the scene's
    own flags, the device scene, the first structures (``trav``,
    ``packed``) and the tracers the app hands ``path_trace`` or
    ``render_frame``."""

    def __init__(self, scene: dict, inputs: dict, argv: list, device):
        from tpu_raytracing_torch.app import main as app
        from tpu_raytracing_torch.bvh.refit_schedule import GuardedRefit
        from tpu_raytracing_torch.scene import procedural
        from tpu_raytracing_torch.scene.types import Library, scene_to_device
        from tpu_raytracing_torch.utils.timing import StageTimer

        tris = inputs["triangles"]
        lib = Library()
        lib.add_material("ground")
        lib.materials[-1].diffuse = np.asarray(scene["material"]["diffuse"], np.float32)
        lib.materials[-1].ambient = np.asarray(scene["material"]["ambient"], np.float32)
        host = procedural._finish(tris, np.zeros(tris.shape[0], np.int32), lib,
                                  np.asarray(scene["light"], np.float32))
        argv = ["--scene", f"terrain:{scene['triangles']}"] + argv
        if scene["pairs"]:
            argv.append("--pairs")
        self.app = app
        self.args = args = app.parse_cmd(argv)
        self.dev_scene = scene_to_device(host, device)
        self.tris0 = torch.as_tensor(tris, device=device)
        self.sched = None
        if args.refit:
            self.sched = GuardedRefit(rebuild=lambda tris: app.split_tree(args, tris),
                                      quality_bound=args.refit_bound,
                                      max_interval=args.refit_interval)
        bvh = pairs = None
        if args.tracer != "split":
            bvh, pairs = app.build_accel(self.tris0, args, StageTimer())
        self.trav, self.packed, self.tracers = app.build_trav(args, self.tris0, bvh, pairs,
                                                              StageTimer(), self.sched)
        self.trav0 = self.trav
        self.seed0 = None if self.sched is None else (self.sched.split0, self.sched.rows0)
        self.rest: dict = {}
        self.bvh = None

    def step(self, t: float) -> float:
        """The structures of an animated step at time ``t``: the app's
        ``animated_trees``. Returns the step's build time in ms. The step's
        binary tree (``--type`` builds) stays alive through the step's
        images, as in the app's loop, and goes before the next build."""
        self.bvh = None
        self.trav, self.packed, self.bvh, record = self.app.animated_trees(
            self.args, self.tris0, t, self.trav, self.sched, self.rest)
        return sum(ms for _, ms in record["stages"])

    def reseed(self) -> None:
        """Back to the state set-up left: frame 0's tree, and the refit
        schedule seeded with it."""
        self.trav, self.bvh = self.trav0, None
        self.rest = {}
        if self.sched is not None:
            from tpu_raytracing_torch.trace.traverse import PackedPairs

            self.sched.seed(self.seed0[0], PackedPairs(rows=self.seed0[1]))


class Reference:
    """The reference's side: the rest triangles on ``device``, wobbled to a
    capture's time; the rest pose's flat normals."""

    def __init__(self, inputs: dict, device):
        self.rest = torch.as_tensor(inputs["triangles"], device=device)
        self.normals = reference.flat_normals(self.rest)

    def geometry(self, t, dtype=torch.float32):
        """(caster, normals) of the capture at time ``t`` (None: still)."""
        tris = self.rest if t is None else reference.wobble(self.rest, float(t))
        return reference.Caster(tris, dtype), self.normals
