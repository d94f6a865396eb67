"""ctypes binding for the native OBJ parser (``csrc/objloader.cpp``).

Port of ``tpu_raytracing/scene/native_loader.py`` (``_ObjMesh``,
``_load_lib``, ``parse_obj``). The reference builds the JAX package's
``csrc/objloader.cpp``, outside its package; the port builds its own copy,
``tpu_raytracing_torch/csrc/objloader.cpp``, with g++ at first use into
``tpu_raytracing_torch/build/`` (keyed by a hash of the source, as the CUDA
kernels are). ``objio.load_obj`` falls back to the pure-Python parser when
this fails, as the reference does, and says which parser ran. Material
names resolved by the C parser are mapped to ids after the Python side
loads the MTL library (texture decode stays in Python).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from tpu_raytracing_torch.ops._cuda_build import BUILD_DIR, SRC_DIR

_LIB = None
SRC = SRC_DIR / "objloader.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


class _ObjMesh(ctypes.Structure):
    _fields_ = [
        ("vertices", ctypes.POINTER(ctypes.c_float)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("face_idx", ctypes.POINTER(ctypes.c_int32)),
        ("face_mat", ctypes.POINTER(ctypes.c_int32)),
        # POINTER(c_char), not c_char_p: the latter auto-converts to bytes on
        # attribute access (truncating at the first NUL of the blob).
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("num_vertices", ctypes.c_int64),
        ("num_uvs", ctypes.c_int64),
        ("num_normals", ctypes.c_int64),
        ("num_tris", ctypes.c_int64),
        ("num_names", ctypes.c_int64),
        ("names_bytes", ctypes.c_int64),
    ]


def _load_lib():
    """Build (if needed) and load the parser; raises on a failed build."""
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"objloader-{digest}.so"
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SRC} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(_ObjMesh)]
    lib.obj_parse.restype = ctypes.c_int
    lib.obj_free.argtypes = [ctypes.POINTER(_ObjMesh)]
    _LIB = lib
    return lib


def parse_obj(filename: str):
    """Parse with the native loader. Returns the tuple objio expects:
    (verts, uvs, normals, face_idx [F, 9], face_mat [F], library)."""
    from tpu_raytracing_torch.scene.objio import load_mtl
    from tpu_raytracing_torch.scene.types import Library

    lib = _load_lib()
    mesh = _ObjMesh()
    rc = lib.obj_parse(filename.encode(), ctypes.byref(mesh))
    if rc != 0:
        raise FileNotFoundError(f"obj_parse({filename}) -> {rc}")
    try:
        def arr(ptr, n, dtype):
            if n == 0:
                return np.zeros((0,), dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)

        verts = arr(mesh.vertices, mesh.num_vertices * 3, np.float32).reshape(-1, 3)
        uvs = arr(mesh.uvs, mesh.num_uvs * 2, np.float32).reshape(-1, 2)
        normals = arr(mesh.normals, mesh.num_normals * 3, np.float32).reshape(-1, 3)
        face_idx = arr(mesh.face_idx, mesh.num_tris * 9, np.int32).reshape(-1, 9)
        face_slot = arr(mesh.face_mat, mesh.num_tris, np.int32)
        blob = ctypes.string_at(mesh.names, mesh.names_bytes)
        parts = blob.split(b"\x00")
        mtllib = parts[0].decode(errors="replace")
        usemtl_names = [s.decode(errors="replace") for s in parts[1 : 1 + mesh.num_names]]
    finally:
        lib.obj_free(ctypes.byref(mesh))

    library = Library()
    if mtllib:
        path = mtllib
        if not os.path.exists(path):
            path = os.path.join(os.path.dirname(filename), mtllib)
        if os.path.exists(path):
            load_mtl(path, library)

    # usemtl slots -> material ids (unknown names stay -1, as the reference's
    # GetMaterialId does, src/FileIO.cpp:186-193).
    slot_to_id = np.array(
        [library.get_material_id(n) for n in usemtl_names] or [-1], np.int32
    )
    face_mat = np.where(face_slot >= 0, slot_to_id[np.maximum(face_slot, 0)], -1)
    return verts, uvs, normals, face_idx, face_mat.astype(np.int32), library
