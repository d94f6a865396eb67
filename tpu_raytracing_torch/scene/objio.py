"""OBJ/MTL/texture asset pipeline (reference: src/FileIO.cpp).

Port of ``tpu_raytracing/scene/objio.py`` (``_load_image_rgba``,
``load_mtl``, ``_resolve_index``, ``setup_light``, ``_generate_normal``,
``load_obj``, ``_assemble_scene``, ``_try_native_parse``), numpy only.

Parsing semantics match the reference loader exactly so identical scenes
produce identical triangle/attribute streams:

* ``f`` polygons are fan-triangulated around vertex 0
  (src/FileIO.cpp:405-432); indices may be negative (relative) or 1-based
  absolute (src/FileIO.cpp:297-325).
* Missing per-corner UVs default to (0, 0); missing normals fall back to the
  flat geometric normal ``normalize(cross(v1-v0, v2-v1))``
  (src/FileIO.cpp:88-93 — note the reference's second edge is v2-v1).
* ``mtllib`` paths resolve relative to the OBJ; ``usemtl`` selects the
  current material id, -1 if unknown (src/FileIO.cpp:367-379).
* The light position loads from a sibling ``light.txt`` else defaults to the
  scene AABB centre (src/FileIO.cpp:74-86).

A native C++ fast path (``csrc/objloader.cpp``, ``scene/native_loader.py``)
parses big meshes; as in the reference, ``load_obj`` falls back to the
pure-Python parser when the native one cannot be built or fails, and here
it prints which parser ran.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from tpu_raytracing_torch.scene.types import Library, Scene


def _load_image_rgba(path: str) -> Optional[np.ndarray]:
    """Decode an image to RGBA8 (the reference uses stb_image,
    src/FileIO.cpp:167-184).

    PIL first (covers JPEG/TGA/...), then the dependency-free PNG
    decoder (utils/png.py) so PNG textures decode even without PIL.
    A texture that still fails WARNS loudly — it renders as 1x1 magenta
    (the reference's missing-mip colour), and silent substitution would
    read as data corruption."""
    err: Exception | None = None
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGBA"), np.uint8)
    except Exception as e:
        err = e
    try:
        from tpu_raytracing_torch.utils.png import read_png

        return read_png(path)
    except Exception as e:
        import sys

        print(f"WARNING: texture '{path}' failed to decode "
              f"(PIL: {err}; png: {e}) — substituting 1x1 magenta",
              file=sys.stderr)
        return None


def load_mtl(filename: str, library: Library) -> None:
    """MTL parser (reference: LoadMTLFromFile, src/FileIO.cpp:222-287).

    Handles newmtl, Ka/Kd/Ks (1- or 3-component), Ns, map_Kd, bump,
    map_Disp; texture paths resolve relative to the MTL file and de-dup by
    name.
    """
    base = os.path.dirname(filename)

    def add_tex(name: str) -> int:
        path = os.path.join(base, name)
        return library.add_texture(path, _load_image_rgba(path))

    with open(filename, "r", errors="replace") as fs:
        for line in fs:
            tokens = line.split()
            if not tokens:
                continue
            key = tokens[0]
            if key == "newmtl" and len(tokens) > 1:
                library.add_material(tokens[1])
            elif key in ("Ka", "Kd", "Ks") and library.materials and len(tokens) > 1:
                if len(tokens) >= 4:
                    vals = np.array([float(tokens[1]), float(tokens[2]), float(tokens[3])], np.float32)
                else:
                    vals = np.full(3, float(tokens[1]), np.float32)
                mat = library.materials[-1]
                if key == "Ka":
                    mat.ambient = vals
                elif key == "Kd":
                    mat.diffuse = vals
                else:
                    mat.specular = vals
            elif key == "map_Kd" and len(tokens) > 1:
                library.materials[-1].texture = add_tex(tokens[1])
            elif key == "bump" and len(tokens) > 1:
                library.materials[-1].bump = add_tex(tokens[1])
            elif key == "map_Disp" and len(tokens) > 1:
                library.materials[-1].disp = add_tex(tokens[1])
            elif key == "Ns" and len(tokens) > 1:
                library.materials[-1].specular_exp = float(tokens[1])


def _resolve_index(token: str, count: int) -> int:
    """OBJ index resolution: negative is relative to the end, positive is
    1-based (src/FileIO.cpp:308-319); empty -> -1."""
    if not token:
        return -1
    f = int(token)
    return f + count if f < 0 else f - 1


def setup_light(obj_filename: str, aabb_min: np.ndarray, aabb_max: np.ndarray) -> np.ndarray:
    """Light from sibling light.txt else the AABB centre (src/FileIO.cpp:74-86)."""
    light = ((aabb_min + aabb_max) * 0.5).astype(np.float32)
    path = os.path.join(os.path.dirname(obj_filename), "light.txt")
    if os.path.exists(path):
        with open(path) as fp:
            vals = fp.read().split()
            light = np.array([float(vals[0]), float(vals[1]), float(vals[2])], np.float32)
    return light


def _generate_normal(v0, v1, v2) -> np.ndarray:
    e1 = v1 - v0
    e2 = v2 - v1
    n = np.cross(e1, e2)
    return (n / np.linalg.norm(n)).astype(np.float32)


def load_obj(filename: str) -> Scene:
    """OBJ loader (reference: LoadOBJFromFile, src/FileIO.cpp:327-458)."""
    native = _try_native_parse(filename)
    if native is not None:
        print(f"OBJ parser: native (csrc/objloader.cpp) for {filename}")
        verts, uvs_buf, norms_buf, face_idx, face_mat, library = native
        return _assemble_scene(filename, verts, uvs_buf, norms_buf, face_idx, face_mat, library)
    print(f"OBJ parser: Python for {filename}")

    library = Library()
    vertex_buffer: List[List[float]] = []
    uv_buffer: List[List[float]] = []
    normals_buffer: List[List[float]] = []
    # Face corners as (v, t, n) index triplets plus per-face material ids.
    face_idx: List[List[int]] = []
    face_mat: List[int] = []
    current_material_id = -1

    with open(filename, "r", errors="replace") as fp:
        for line in fp:
            tokens = line.split()
            if not tokens or tokens[0] == "#":
                continue
            key = tokens[0]
            if key == "mtllib":
                mtl_filename = tokens[1]
                if not os.path.exists(mtl_filename):
                    mtl_filename = os.path.join(os.path.dirname(filename), tokens[1])
                if os.path.exists(mtl_filename):
                    load_mtl(mtl_filename, library)
            elif key == "usemtl":
                current_material_id = library.get_material_id(tokens[1])
            elif key == "v":
                vertex_buffer.append([float(tokens[1]), float(tokens[2]), float(tokens[3])])
            elif key == "vt":
                uv_buffer.append([float(tokens[1]), float(tokens[2])])
            elif key == "vn":
                normals_buffer.append([float(tokens[1]), float(tokens[2]), float(tokens[3])])
            elif key == "f":
                corners = []
                for trip in tokens[1:]:
                    parts = trip.split("/")
                    v = _resolve_index(parts[0], len(vertex_buffer))
                    t = _resolve_index(parts[1] if len(parts) > 1 else "", len(uv_buffer))
                    n = _resolve_index(parts[2] if len(parts) > 2 else "", len(normals_buffer))
                    corners.append((v, t, n))
                # Fan triangulation around corner 0 (src/FileIO.cpp:405-432).
                for i in range(2, len(corners)):
                    face_idx.append(list(corners[0] + corners[i - 1] + corners[i]))
                    face_mat.append(current_material_id)

    verts = np.asarray(vertex_buffer, np.float32).reshape(-1, 3)
    uvs_buf = np.asarray(uv_buffer, np.float32).reshape(-1, 2)
    norms_buf = np.asarray(normals_buffer, np.float32).reshape(-1, 3)
    fidx = np.asarray(face_idx, np.int32).reshape(-1, 9)
    fmat = np.asarray(face_mat, np.int32)
    return _assemble_scene(filename, verts, uvs_buf, norms_buf, fidx, fmat, library)


def _assemble_scene(filename, verts, uvs_buf, norms_buf, fidx, fmat, library) -> Scene:
    """Gather per-face corner data into SoA triangle/attribute arrays."""
    num = fidx.shape[0]
    vi = fidx[:, [0, 3, 6]]
    ti = fidx[:, [1, 4, 7]]
    ni = fidx[:, [2, 5, 8]]

    triangles = verts[vi]  # [T, 3, 3]

    uvs = np.zeros((num, 3, 2), np.float32)
    if uvs_buf.size:
        valid_t = ti >= 0
        uvs[valid_t] = uvs_buf[ti[valid_t]]

    # Flat geometric normal fallback for corners without vn.
    flat = np.zeros((num, 3), np.float32)
    if num:
        e1 = triangles[:, 1] - triangles[:, 0]
        e2 = triangles[:, 2] - triangles[:, 1]
        n = np.cross(e1, e2)
        lens = np.linalg.norm(n, axis=-1, keepdims=True)
        flat = (n / np.where(lens == 0, 1, lens)).astype(np.float32)
    normals = np.repeat(flat[:, None, :], 3, axis=1)
    if norms_buf.size:
        valid_n = ni >= 0
        normals[valid_n] = norms_buf[ni[valid_n]]

    if num:
        aabb_min = triangles.reshape(-1, 3).min(axis=0)
        aabb_max = triangles.reshape(-1, 3).max(axis=0)
    else:
        aabb_min = np.zeros(3, np.float32)
        aabb_max = np.zeros(3, np.float32)

    return Scene(
        triangles=triangles.astype(np.float32),
        normals=normals.astype(np.float32),
        uvs=uvs,
        material_ids=fmat.astype(np.int32),
        library=library,
        aabb_min=aabb_min.astype(np.float32),
        aabb_max=aabb_max.astype(np.float32),
        light=setup_light(filename, aabb_min, aabb_max),
    )


def _try_native_parse(filename: str):
    """Use the C++ loader (csrc/objloader.cpp) when it builds; None, with
    the reason printed, to fall back."""
    try:
        from tpu_raytracing_torch.scene import native_loader

        return native_loader.parse_obj(filename)
    except Exception as e:  # the reference falls back on any failure
        print(f"OBJ parser: the native parser failed ({type(e).__name__}: {e})")
        return None
