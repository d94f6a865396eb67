"""Scene, material/texture library and device-side scene views.

Port of ``tpu_raytracing/scene/types.py``. The host classes (``Texture``,
``Material``, ``Library``, ``Scene``) are numpy-only copies of the
reference's: its module imports flax and jax at the top, so the port keeps
its own. The device views (``TexturePool``, ``DeviceMaterials``,
``DeviceScene``) are plain dataclasses of torch tensors in place of
``flax.struct`` pytrees, built on an explicit ``device``.

Textures: all mips of all textures are packed into one flat RGBA8 texel
pool plus (texture, lod) offset/size tables, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

# Mirror of the reference's compile-time texture limits (src/Common.cuh:17-18).
MAX_TEXTURE_SIZE = 1024 * 8
NUM_LODS = 13


@dataclasses.dataclass
class Texture:
    """Host texture with a CPU box-filter mip chain (src/Common.cuh:61-91)."""

    name: str
    mips: List[np.ndarray]  # each [h, w, 4] uint8
    max_lod: int = 0

    @property
    def size0(self):
        return self.mips[0].shape[1], self.mips[0].shape[0]

    def generate_lods(self) -> None:
        """Box-filter mip chain, clamped reads at odd edges
        (src/FileIO.cpp:121-150): next size is ceil(size/2); each texel
        averages a 2x2 footprint with clamped coordinates in float and
        truncates back to uint8."""
        while self.mips[-1].shape[0] > 1 or self.mips[-1].shape[1] > 1:
            src = self.mips[-1].astype(np.float32)
            h, w = src.shape[0], src.shape[1]
            nh, nw = (h + 1) // 2, (w + 1) // 2
            x0 = np.minimum(np.arange(nw) * 2, w - 1)
            x1 = np.minimum(np.arange(nw) * 2 + 1, w - 1)
            y0 = np.minimum(np.arange(nh) * 2, h - 1)
            y1 = np.minimum(np.arange(nh) * 2 + 1, h - 1)
            nxt = (
                src[np.ix_(y0, x0)] + src[np.ix_(y0, x1)] + src[np.ix_(y1, x0)] + src[np.ix_(y1, x1)]
            ) * 0.25
            self.mips.append(nxt.astype(np.uint8))
        self.max_lod = len(self.mips) - 1


@dataclasses.dataclass
class Material:
    """Phong material (reference: src/Common.cuh:93-129)."""

    name: str = ""
    ambient: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    diffuse: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    specular: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    specular_exp: float = 0.0
    texture: int = -1
    bump: int = -1
    disp: int = -1


@dataclasses.dataclass
class Library:
    """Material/texture library with name de-dup (src/Common.cuh:131-150)."""

    materials: List[Material] = dataclasses.field(default_factory=list)
    textures: List[Texture] = dataclasses.field(default_factory=list)
    name_to_mat: Dict[str, int] = dataclasses.field(default_factory=dict)
    name_to_tex: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add_material(self, name: str) -> None:
        self.name_to_mat[name] = len(self.materials)
        self.materials.append(Material(name=name))

    def add_texture(self, name: str, rgba: Optional[np.ndarray]) -> int:
        """De-dup by name; generates the mip chain on first load."""
        if name in self.name_to_tex:
            return self.name_to_tex[name]
        idx = len(self.textures)
        self.name_to_tex[name] = idx
        if rgba is None:
            rgba = np.full((1, 1, 4), (255, 0, 255, 255), np.uint8)
        tex = Texture(name=name, mips=[np.ascontiguousarray(rgba, np.uint8)])
        tex.generate_lods()
        self.textures.append(tex)
        return idx

    def get_material_id(self, name: str) -> int:
        return self.name_to_mat.get(name, -1)


@dataclasses.dataclass
class Scene:
    """Host scene (reference: src/FileIO.h:11-24): ``triangles`` is
    [T, 3, 3] float32; attribute arrays are SoA."""

    triangles: np.ndarray  # [T, 3, 3] float32
    normals: np.ndarray  # [T, 3, 3] float32 — per-corner shading normals
    uvs: np.ndarray  # [T, 3, 2] float32
    material_ids: np.ndarray  # [T] int32 (-1 = no material)
    library: Library
    aabb_min: np.ndarray  # [3] float32
    aabb_max: np.ndarray  # [3] float32
    light: np.ndarray  # [3] float32

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])


@dataclasses.dataclass
class TexturePool:
    """All mips of all textures in one flat RGBA texel pool; ``offset[t, l]``
    is texel (0, 0) of texture t's mip l, -1 marks a missing mip."""

    texels: torch.Tensor  # [K, 4] uint8
    offset: torch.Tensor  # [T, NUM_LODS] int32
    width: torch.Tensor  # [T, NUM_LODS] int32
    height: torch.Tensor  # [T, NUM_LODS] int32
    max_lod: torch.Tensor  # [T] int32


@dataclasses.dataclass
class DeviceMaterials:
    ambient: torch.Tensor  # [M, 3] float32
    diffuse: torch.Tensor  # [M, 3] float32
    specular: torch.Tensor  # [M, 3] float32
    specular_exp: torch.Tensor  # [M] float32
    texture: torch.Tensor  # [M] int32
    bump: torch.Tensor  # [M] int32
    disp: torch.Tensor  # [M] int32


@dataclasses.dataclass
class DeviceScene:
    """Device-side scene view (reference: src/Common.cuh:342-351)."""

    normals: torch.Tensor  # [T, 3, 3] float32
    uvs: torch.Tensor  # [T, 3, 2] float32
    material_ids: torch.Tensor  # [T] int32
    materials: DeviceMaterials
    textures: TexturePool
    light: torch.Tensor  # [3] float32
    num_materials: int


def build_texture_pool(textures: List[Texture], device) -> TexturePool:
    """Pack host textures (all mips) into a flat pool on ``device``."""
    num = max(len(textures), 1)
    offset = np.full((num, NUM_LODS), -1, np.int32)
    width = np.zeros((num, NUM_LODS), np.int32)
    height = np.zeros((num, NUM_LODS), np.int32)
    max_lod = np.zeros((num,), np.int32)
    chunks = []
    cursor = 0
    for t, tex in enumerate(textures):
        max_lod[t] = tex.max_lod
        for l, mip in enumerate(tex.mips[:NUM_LODS]):
            h, w = mip.shape[0], mip.shape[1]
            offset[t, l] = cursor
            width[t, l] = w
            height[t, l] = h
            chunks.append(mip.reshape(-1, 4))
            cursor += h * w
    if chunks:
        texels = np.concatenate(chunks, axis=0)
    else:
        texels = np.full((1, 4), (255, 0, 255, 255), np.uint8)
    return TexturePool(
        texels=torch.as_tensor(texels, device=device),
        offset=torch.as_tensor(offset, device=device),
        width=torch.as_tensor(width, device=device),
        height=torch.as_tensor(height, device=device),
        max_lod=torch.as_tensor(max_lod, device=device),
    )


def build_device_materials(materials: List[Material], device) -> DeviceMaterials:
    """Material table; one default entry is appended for material_id == -1."""
    mats = list(materials) + [
        Material(name="__default__", diffuse=np.array([0.7, 0.7, 0.7], np.float32))
    ]

    def f32(rows):
        return torch.as_tensor(np.stack(rows).astype(np.float32), device=device)

    def i32(vals):
        return torch.as_tensor(np.array(vals, np.int32), device=device)

    return DeviceMaterials(
        ambient=f32([m.ambient for m in mats]),
        diffuse=f32([m.diffuse for m in mats]),
        specular=f32([m.specular for m in mats]),
        specular_exp=torch.as_tensor(
            np.array([m.specular_exp for m in mats], np.float32), device=device),
        texture=i32([m.texture for m in mats]),
        bump=i32([m.bump for m in mats]),
        disp=i32([m.disp for m in mats]),
    )


def scene_to_device(scene: Scene, device) -> DeviceScene:
    """Host -> device scene upload (reference: src/main.cu:421-456)."""
    return DeviceScene(
        normals=torch.as_tensor(scene.normals.astype(np.float32), device=device),
        uvs=torch.as_tensor(scene.uvs.astype(np.float32), device=device),
        material_ids=torch.as_tensor(scene.material_ids.astype(np.int32), device=device),
        materials=build_device_materials(scene.library.materials, device),
        textures=build_texture_pool(scene.library.textures, device),
        light=torch.as_tensor(scene.light.astype(np.float32), device=device),
        num_materials=len(scene.library.materials),
    )
