"""Procedural test scenes.

Port of ``tpu_raytracing/scene/procedural.py`` (whole module): the
generators are copied verbatim, in numpy, so the port's arrays are
byte-equal to the reference's, and only the ``Scene`` container comes from
the port. ``animate_triangles`` runs on torch tensors, so the animated app
moves its geometry on the card.

The reference ships no assets (scenes are user OBJ files), while the
benchmark configs (BASELINE.md) need Cornell-box, bunny-scale, Sponza-scale
and 1M-triangle inputs. These generators produce deterministic scenes at any
triangle count, in the same Scene container the OBJ loader emits.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_raytracing_torch.scene.types import Library, Scene


def _finish(triangles: np.ndarray, material_ids: np.ndarray, library: Library,
            light: np.ndarray | None = None) -> Scene:
    triangles = triangles.astype(np.float32)
    num = triangles.shape[0]
    e1 = triangles[:, 1] - triangles[:, 0]
    e2 = triangles[:, 2] - triangles[:, 1]
    n = np.cross(e1, e2)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    flat = (n / np.where(lens == 0, 1, lens)).astype(np.float32)
    normals = np.repeat(flat[:, None, :], 3, axis=1)
    uvs = np.zeros((num, 3, 2), np.float32)
    # Simple planar UVs so texture modes have something to sample.
    if num:
        uvs[:, :, 0] = (triangles[:, :, 0] - triangles[:, :, 0].min()) % 1.0
        uvs[:, :, 1] = (triangles[:, :, 1] - triangles[:, :, 1].min()) % 1.0
    aabb_min = triangles.reshape(-1, 3).min(axis=0) if num else np.zeros(3, np.float32)
    aabb_max = triangles.reshape(-1, 3).max(axis=0) if num else np.zeros(3, np.float32)
    if light is None:
        light = ((aabb_min + aabb_max) * 0.5).astype(np.float32)
    return Scene(
        triangles=triangles,
        normals=normals,
        uvs=uvs,
        material_ids=material_ids.astype(np.int32),
        library=library,
        aabb_min=aabb_min.astype(np.float32),
        aabb_max=aabb_max.astype(np.float32),
        light=np.asarray(light, np.float32),
    )


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (counter-clockwise)."""
    return [[a, b, c], [a, c, d]]


def cornell_box() -> Scene:
    """Cornell-box-like scene: 5 walls, 2 boxes (30 tris), Phong materials."""
    tris = []
    mats = []
    lib = Library()
    for name, kd in [
        ("white", (0.73, 0.73, 0.73)),
        ("red", (0.65, 0.05, 0.05)),
        ("green", (0.12, 0.45, 0.15)),
    ]:
        lib.add_material(name)
        lib.materials[-1].diffuse = np.array(kd, np.float32)
        lib.materials[-1].ambient = np.array(kd, np.float32)

    s = 1.0

    def add(quads, mat):
        for t in quads:
            tris.append(t)
            mats.append(mat)

    # floor (y=0), ceiling (y=2s), back wall (z=2s), left (x=-s) red, right (x=s) green
    f00, f01, f11, f10 = (-s, 0, 0), (-s, 0, 2 * s), (s, 0, 2 * s), (s, 0, 0)
    add(_quad(f00, f01, f11, f10), 0)
    c00, c01, c11, c10 = (-s, 2 * s, 0), (s, 2 * s, 0), (s, 2 * s, 2 * s), (-s, 2 * s, 2 * s)
    add(_quad(c00, c01, c11, c10), 0)
    b00, b01, b11, b10 = (-s, 0, 2 * s), (-s, 2 * s, 2 * s), (s, 2 * s, 2 * s), (s, 0, 2 * s)
    add(_quad(b00, b01, b11, b10), 0)
    l00, l01, l11, l10 = (-s, 0, 0), (-s, 2 * s, 0), (-s, 2 * s, 2 * s), (-s, 0, 2 * s)
    add(_quad(l00, l01, l11, l10), 1)
    r00, r01, r11, r10 = (s, 0, 0), (s, 0, 2 * s), (s, 2 * s, 2 * s), (s, 2 * s, 0)
    add(_quad(r00, r01, r11, r10), 2)

    def box(cx, cz, w, h):
        x0, x1, z0, z1 = cx - w, cx + w, cz - w, cz + w
        quads = []
        quads += _quad((x0, 0, z0), (x0, h, z0), (x1, h, z0), (x1, 0, z0))
        quads += _quad((x0, 0, z1), (x1, 0, z1), (x1, h, z1), (x0, h, z1))
        quads += _quad((x0, 0, z0), (x0, 0, z1), (x0, h, z1), (x0, h, z0))
        quads += _quad((x1, 0, z0), (x1, h, z0), (x1, h, z1), (x1, 0, z1))
        quads += _quad((x0, h, z0), (x0, h, z1), (x1, h, z1), (x1, h, z0))
        return quads

    add(box(-0.35, 1.2, 0.3, 1.2), 0)
    add(box(0.35, 0.7, 0.28, 0.6), 0)

    light = np.array([0.0, 1.95, 1.0], np.float32)
    return _finish(np.asarray(tris, np.float32), np.asarray(mats, np.int32), lib, light)


def icosphere(subdivisions: int = 4, radius: float = 1.0,
              centre=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Subdivided icosahedron: 20 * 4^s triangles (s=6 -> 81920)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        np.int64,
    )
    tris = verts[faces]  # [F, 3, 3]
    for _ in range(subdivisions):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        for m in (ab, bc, ca):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        tris = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ],
            axis=0,
        )
    return (tris * radius + np.asarray(centre)).astype(np.float32)


def sphere_scene(subdivisions: int = 4) -> Scene:
    """Bunny-scale stand-in: a finely subdivided sphere on a ground plane."""
    lib = Library()
    lib.add_material("body")
    lib.materials[-1].diffuse = np.array([0.7, 0.6, 0.5], np.float32)
    lib.materials[-1].ambient = np.array([0.7, 0.6, 0.5], np.float32)
    lib.materials[-1].specular = np.array([0.3, 0.3, 0.3], np.float32)
    lib.materials[-1].specular_exp = 16.0
    lib.add_material("ground")
    lib.materials[-1].diffuse = np.array([0.5, 0.5, 0.55], np.float32)
    lib.materials[-1].ambient = np.array([0.5, 0.5, 0.55], np.float32)

    body = icosphere(subdivisions, radius=1.0, centre=(0.0, 1.0, 0.0))
    g = 4.0
    ground = np.array(
        _quad((-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)), np.float32
    )
    tris = np.concatenate([body, ground], axis=0)
    mats = np.concatenate(
        [np.zeros(body.shape[0], np.int32), np.ones(ground.shape[0], np.int32)]
    )
    return _finish(tris, mats, lib, light=np.array([2.0, 4.0, -2.0], np.float32))


def random_triangle_soup(num_triangles: int, seed: int = 0, extent: float = 10.0,
                         tri_size: float = 0.08) -> Scene:
    """Dense random soup at any triangle count (1M-tri benchmark scene)."""
    rng = np.random.default_rng(seed)
    centres = (rng.random((num_triangles, 1, 3), np.float32) - 0.5) * extent
    offsets = (rng.random((num_triangles, 3, 3), np.float32) - 0.5) * (extent * tri_size / 10.0)
    tris = centres + offsets
    lib = Library()
    lib.add_material("soup")
    lib.materials[-1].diffuse = np.array([0.8, 0.8, 0.8], np.float32)
    lib.materials[-1].ambient = np.array([0.8, 0.8, 0.8], np.float32)
    mats = np.zeros(num_triangles, np.int32)
    return _finish(tris, mats, lib)


def terrain(num_triangles: int, extent: float = 100.0, height: float = 8.0,
            seed: int = 0) -> Scene:
    """Tessellated heightfield with ~num_triangles triangles.

    The structured-mesh counterpart to random_triangle_soup for the 1M-tri
    benchmarks: real scenes are surfaces, and BVH traversal depth on a
    surface is logarithmic where a volumetric soup degenerates to near-linear
    (every ray overlaps thousands of boxes).
    """
    n = max(int(np.sqrt(num_triangles / 2)), 2)
    xs = np.linspace(-extent / 2, extent / 2, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs)
    rng = np.random.default_rng(seed)
    gy = (
        height * np.sin(gx * 0.11) * np.cos(gz * 0.13)
        + 0.3 * height * np.sin(gx * 0.71 + 1.3) * np.sin(gz * 0.53)
        + rng.normal(0, 0.05 * height, gx.shape)
    ).astype(np.float32)
    verts = np.stack([gx, gy, gz], axis=-1)  # [n+1, n+1, 3]

    v00 = verts[:-1, :-1].reshape(-1, 3)
    v01 = verts[:-1, 1:].reshape(-1, 3)
    v10 = verts[1:, :-1].reshape(-1, 3)
    v11 = verts[1:, 1:].reshape(-1, 3)
    # Interleave each quad's two halves so triangles (2t, 2t+1) share the
    # diagonal edge — the adjacency the reference's pairing probes
    # (src/BottomUpBuilder.cu:117-164 pairs consecutive indices).
    upper = np.stack([v00, v01, v11], axis=1)
    lower = np.stack([v00, v11, v10], axis=1)
    tris = np.stack([upper, lower], axis=1).reshape(-1, 3, 3).astype(np.float32)

    lib = Library()
    lib.add_material("ground")
    lib.materials[-1].diffuse = np.array([0.55, 0.5, 0.45], np.float32)
    lib.materials[-1].ambient = np.array([0.55, 0.5, 0.45], np.float32)
    mats = np.zeros(tris.shape[0], np.int32)
    # Sun-like light high above: near-vertical shadow rays (a low light
    # makes every shadow ray graze the whole heightfield).
    light = np.array([0.0, 2.0 * extent, 0.0], np.float32)
    return _finish(tris, mats, lib, light)


def animate_triangles(triangles: torch.Tensor, time: float,
                      amplitude: float = 0.05) -> torch.Tensor:
    """Per-frame vertex animation for the animated-rebuild benchmark:
    a smooth positional wobble that forces a full LBVH rebuild each frame.

    The reference's numpy function on a tensor of vertices ([..., 3]
    float32; triangles [N, 3, 3] or pair rows' vertices [P, 4, 3]), on the
    tensor's device, in float32. Each vertex moves by a function of its own
    position, so equal vertices move alike."""
    phase = triangles[..., 0] * 1.7 + triangles[..., 2] * 1.3
    wobble = torch.stack([torch.sin(phase * 2.0 + time), torch.cos(phase * 3.0 + time * 1.3),
                          torch.sin(phase * 2.5 + time * 0.7)], dim=-1)
    return triangles + amplitude * wobble