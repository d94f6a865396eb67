"""Deterministic bunny-class OBJ asset generator.

Port of ``tpu_raytracing/scene/genasset.py`` (``generate_rock``), numpy
only, writing through the port's ``utils/png.write_png``. For the same
arguments it writes the reference's files byte for byte, their "generated
by tpu_raytracing.scene.genasset" header lines included.

The reference's entire workflow is user OBJ files with MTL materials and
textures (src/FileIO.cpp:327-458); the repo cannot ship Stanford assets,
so this generates an equivalent *real file-based asset*: an organic
~80k-triangle displaced icosphere ("rock") written as a genuine OBJ with
v/vt/vn records, quad faces (exercising the loader's fan triangulation,
FileIO.cpp:405-432), an MTL with Ka/Kd/Ks/Ns + map_Kd, a generated PNG
texture and a sibling light.txt — so the full asset pipeline (parse ->
materials -> texture decode -> mips -> build -> trace) runs on real
files, not procedural arrays.

Deterministic by seed: tests and benchmarks regenerate identical bytes.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_raytracing_torch.utils.png import write_png


def _icosphere(subdivisions: int):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        cache = {}
        verts_list = [v for v in verts]

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                cache[key] = len(verts_list)
                verts_list.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces


def _value_noise3(p: np.ndarray, seed: int, res: int = 16) -> np.ndarray:
    """Trilinear 3D value noise on a periodic random grid; p in cells."""
    rng = np.random.default_rng(seed)
    grid = rng.random((res, res, res)).astype(np.float64)
    pi = np.floor(p).astype(np.int64)
    pf = p - pi

    def g(dx, dy, dz):
        return grid[(pi[:, 0] + dx) % res, (pi[:, 1] + dy) % res,
                    (pi[:, 2] + dz) % res]

    fx, fy, fz = (pf[:, i] * pf[:, i] * (3 - 2 * pf[:, i]) for i in range(3))
    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _fbm(p: np.ndarray, seed: int, octaves: int = 4) -> np.ndarray:
    total = np.zeros(p.shape[0])
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        total += amp * _value_noise3(p * freq + o * 7.13, seed + o)
        norm += amp
        amp *= 0.5
        freq *= 2.0
    return total / norm


def generate_rock(out_dir: str, subdivisions: int = 6, seed: int = 7,
                  tex_size: int = 256, name: str = "rock") -> str:
    """Write <name>.obj/.mtl/_tex.png/light.txt into out_dir; returns the
    OBJ path. subdivisions=6 -> 81,920 sphere tris + a 2-quad ground
    (fan-triangulated by the loader) ~= the bunny-class scale of
    BASELINE config 2."""
    obj_path = os.path.join(out_dir, f"{name}.obj")
    if os.path.exists(obj_path):
        return obj_path  # deterministic by construction: cache hit
    os.makedirs(out_dir, exist_ok=True)
    verts, faces = _icosphere(subdivisions)

    # Organic displacement: fBm radius + a low-frequency squash.
    disp = _fbm(verts * 3.0 + 11.0, seed)
    r = 1.0 + 0.45 * (disp - 0.5)
    verts = verts * r[:, None]
    verts[:, 1] *= 0.85  # slightly squashed, sits on the ground

    # Spherical UVs + smooth normals (finite-difference over the sphere
    # would be overkill; renormalized displaced positions read well).
    d = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    uu = 0.5 + np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi)
    vv = 0.5 - np.arcsin(np.clip(d[:, 1], -1, 1)) / np.pi
    normals = d

    ymin = verts[:, 1].min()
    g = 2.2  # ground half-extent
    gverts = np.array([[-g, ymin, -g], [g, ymin, -g], [g, ymin, g],
                       [-g, ymin, g]])
    guv = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float64)
    gn = np.array([[0, 1, 0]], np.float64)

    # --- texture: banded marble-ish noise ---
    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size),
                         indexing="ij")
    pt = np.stack([xx.ravel() / tex_size * 8, yy.ravel() / tex_size * 8,
                   np.zeros(tex_size * tex_size)], axis=1)
    n = _fbm(pt, seed + 100, octaves=5).reshape(tex_size, tex_size)
    band = 0.5 + 0.5 * np.sin(xx / tex_size * 14.0 + 6.0 * n)
    rch = (120 + 110 * band).astype(np.uint8)
    gch = (100 + 90 * band * (0.8 + 0.2 * n)).astype(np.uint8)
    bch = (90 + 60 * (1 - band)).astype(np.uint8)
    tex = np.stack([rch, gch, bch], axis=-1)

    tex_name = f"{name}_tex.png"
    write_png(os.path.join(out_dir, tex_name), tex)

    with open(os.path.join(out_dir, f"{name}.mtl"), "w") as f:
        f.write(f"""# generated by tpu_raytracing.scene.genasset (seed {seed})
newmtl rockmat
Ka 0.10 0.10 0.10
Kd 0.85 0.82 0.78
Ks 0.30 0.30 0.30
Ns 32.0
map_Kd {tex_name}

newmtl groundmat
Ka 0.10 0.10 0.10
Kd 0.55 0.55 0.60
Ks 0.05 0.05 0.05
Ns 8.0
map_Kd {tex_name}
""")

    # (obj_path computed above for the cache check)
    with open(obj_path, "w") as f:
        f.write(f"# generated by tpu_raytracing.scene.genasset "
                f"(subdiv {subdivisions}, seed {seed})\n")
        f.write(f"mtllib {name}.mtl\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for v in gverts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for i in range(len(verts)):
            f.write(f"vt {uu[i]:.6f} {vv[i]:.6f}\n")
        for t in guv:
            f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for nrm in normals:
            f.write(f"vn {nrm[0]:.6f} {nrm[1]:.6f} {nrm[2]:.6f}\n")
        f.write(f"vn {gn[0][0]:.6f} {gn[0][1]:.6f} {gn[0][2]:.6f}\n")
        f.write("usemtl rockmat\n")
        for a, b, c in faces + 1:
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
        nv = len(verts)
        nn = len(normals) + 1
        f.write("usemtl groundmat\n")
        # One QUAD face (fan-triangulated by the loader) with negative
        # vt indices exercising FileIO.cpp:401-432 semantics.
        f.write(
            f"f {nv + 1}/{nv + 1}/{nn} {nv + 2}/{nv + 2}/{nn} "
            f"{nv + 3}/{nv + 3}/{nn} {nv + 4}/{nv + 4}/{nn}\n")

    # Light above and to the side, as a real asset would ship.
    centre = verts.mean(axis=0)
    with open(os.path.join(out_dir, "light.txt"), "w") as f:
        f.write(f"{centre[0] + 2.5:.3f} {centre[1] + 4.0:.3f} "
                f"{centre[2] - 2.0:.3f}\n")
    return obj_path
