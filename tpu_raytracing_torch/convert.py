"""Carry the JAX package's structures, given as numpy arrays, into the port.

With these, a structure built by ``tpu_raytracing`` can be consumed by the
next stage of ``tpu_raytracing_torch`` — e.g. a JAX-built split BVH traced
by the port's traversal — so a disagreement points at one slice. The
module itself imports numpy and torch only; the caller converts JAX arrays
with ``np.asarray``.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from tpu_raytracing_torch.bvh.bucket import SplitBVH, stack_cap
from tpu_raytracing_torch.bvh.grid import UniformGrid
from tpu_raytracing_torch.bvh.tlas import InstancedAS
from tpu_raytracing_torch.bvh.treelet import TreeletBVH
from tpu_raytracing_torch.bvh.types import BVH
from tpu_raytracing_torch.bvh.wide import FatWideBVH, WideBVH
from tpu_raytracing_torch.scene.types import DeviceMaterials, DeviceScene, TexturePool
from tpu_raytracing_torch.trace.grid_instanced import InstancedGridAS
from tpu_raytracing_torch.trace.instanced_split import InstancedSplitAS
from tpu_raytracing_torch.trace.wavefront_bfs import BFSViews
from tpu_raytracing_torch.trace.traverse import PackedPairs, TraversalBVH


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def scene_from_numpy(fields: Mapping, device) -> DeviceScene:
    """``tpu_raytracing.scene.types.DeviceScene`` as a mapping of numpy
    arrays (``materials`` and ``textures`` as nested mappings of their
    fields) -> the port's ``DeviceScene`` on ``device``."""
    mats = fields["materials"]
    tex = fields["textures"]
    return DeviceScene(
        normals=_t(fields["normals"], device),
        uvs=_t(fields["uvs"], device),
        material_ids=_t(fields["material_ids"], device),
        materials=DeviceMaterials(**{k: _t(mats[k], device) for k in (
            "ambient", "diffuse", "specular", "specular_exp", "texture", "bump", "disp")}),
        textures=TexturePool(**{k: _t(tex[k], device) for k in (
            "texels", "offset", "width", "height", "max_lod")}),
        light=_t(fields["light"], device),
        num_materials=int(fields["num_materials"]),
    )


def packed_from_numpy(rows, device) -> PackedPairs:
    """``PackedPairs.rows`` [P, 16] int32 -> the port's ``PackedPairs``."""
    return PackedPairs(rows=_t(np.asarray(rows, np.int32), device))


def split_views_from_numpy(inner_i, inner_v, pairs_f,
                           device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The reference kernel views of a bucket tree
    (``bucket.emit_split_views``) -> the port's ``(inner, pairs,
    stack_cap)``, with the bucket tree's stack bound (``bucket.stack_cap``).
    An SAH tree comes over with ``sah_split_from_numpy``.

    Strips the 128-lane Mosaic padding: ``inner_i`` [ICAP, 128] keeps its
    first w*8 words as [ICAP, w, 8] (w from ``inner_v`` [ICAP, w, 128]);
    ``pairs_f`` [max(P, 128), 128] f32 keeps its first 16 words, as int32
    bits. The reference pads pairs to at least 128 rows, so every leaf
    window of width <= 128 stays in range.
    """
    inner_i = np.asarray(inner_i, np.int32)
    w = np.asarray(inner_v).shape[1]
    inner = inner_i[:, : w * 8].reshape(inner_i.shape[0], w, 8)
    pairs = np.asarray(pairs_f, np.float32).view(np.int32)[:, :16]
    return _t(inner, device), _t(pairs, device), stack_cap(w, pairs.shape[0])


def sah_split_from_numpy(fields: Mapping, rows, device) -> Tuple[SplitBVH, PackedPairs]:
    """``tpu_raytracing.bvh.split_convert.build_sah_split``'s ``SplitBVH``
    as a mapping of numpy arrays (``inner``, ``num_inner``, ``num_leaves``,
    ``e_ranges``, ``leaf_width``) and its ``PackedPairs.rows`` -> the port's
    (``SplitBVH``, ``PackedPairs``); ``bvh/split_convert.sah_split_views``
    makes K1's views of them."""
    split = SplitBVH(inner=_t(np.asarray(fields["inner"], np.int32), device),
                     num_inner=_t(np.asarray(fields["num_inner"], np.int64), device),
                     num_leaves=_t(np.asarray(fields["num_leaves"], np.int64), device),
                     leaf_width=int(fields["leaf_width"]),
                     e_ranges=_t(np.asarray(fields["e_ranges"], np.int32), device))
    return split, packed_from_numpy(rows, device)


def treelet_from_numpy(fields: Mapping, device) -> TreeletBVH:
    """``tpu_raytracing.bvh.treelet.TreeletBVH`` as a mapping of numpy arrays
    (``tables``, ``num_treelets``, ``root_tid``, ``max_col``,
    ``num_leaves``, ``pair_tid``) and its ``leaf_width`` -> the port's
    ``TreeletBVH`` on ``device``. The layouts are the same; ``columns`` is
    made from ``tables``."""
    tables = _t(np.asarray(fields["tables"], np.float32), device)
    return TreeletBVH(
        tables=tables,
        columns=tables.transpose(1, 2).contiguous(),
        num_treelets=_t(fields["num_treelets"], device),
        root_tid=_t(np.asarray(fields["root_tid"], np.int32), device),
        max_col=_t(fields["max_col"], device),
        num_leaves=_t(fields["num_leaves"], device),
        pair_tid=_t(np.asarray(fields["pair_tid"], np.int32), device),
        leaf_width=int(fields["leaf_width"]),
    )


def bvh_from_numpy(fields: Mapping, device) -> BVH:
    """``tpu_raytracing.bvh.types.BVH`` as a mapping of numpy arrays
    (``node_min``, ``node_max``, ``child``, ``count``, ``type``,
    ``parent``, ``root``, ``root_count``) -> the port's ``BVH``."""
    f32 = {"node_min", "node_max"}
    return BVH(**{k: _t(np.asarray(fields[k], np.float32 if k in f32 else np.int32), device)
                  for k in ("node_min", "node_max", "child", "count", "type", "parent",
                            "root", "root_count")})


def traversal_from_numpy(rows, root, root_count, device) -> TraversalBVH:
    """``TraversalBVH`` (``pack_bvh``) fields -> the port's."""
    return TraversalBVH(rows=_t(np.asarray(rows, np.int32), device),
                        root=_t(np.asarray(root, np.int32), device),
                        root_count=_t(np.asarray(root_count, np.int32), device))


def wide_from_numpy(rows, num_nodes, device) -> WideBVH:
    """``WideBVH`` (``build_wide``) fields -> the port's."""
    return WideBVH(rows=_t(np.asarray(rows, np.int32), device),
                   num_nodes=_t(np.asarray(num_nodes, np.int64), device))


def fat_from_numpy(rows, num_nodes, device) -> FatWideBVH:
    """``FatWideBVH`` (``build_wide_fat``) fields -> the port's; pad its
    rows with ``ops/fat_traverse.pad_rows_256`` for K6."""
    return FatWideBVH(rows=_t(np.asarray(rows, np.int32), device),
                      num_nodes=_t(np.asarray(num_nodes, np.int64), device),
                      live_rows=int(num_nodes))


def grid_from_numpy(fields: Mapping, device) -> UniformGrid:
    """``tpu_raytracing.bvh.grid.UniformGrid`` as a mapping of numpy arrays
    (``cell_start``, ``cell_count``, ``refs``, ``big``, ``num_big``,
    ``overflow``, ``grid_min``, ``grid_max``, ``cell_size``, ``cell_word``)
    and its host tuple ``res`` -> the port's ``UniformGrid``."""
    f32 = {"grid_min", "grid_max", "cell_size"}
    return UniformGrid(res=tuple(int(r) for r in fields["res"]), **{
        k: _t(np.asarray(fields[k], np.float32 if k in f32 else np.int32), device)
        for k in ("cell_start", "cell_count", "refs", "big", "num_big", "overflow",
                  "grid_min", "grid_max", "cell_size", "cell_word")})


def instanced_from_numpy(fields: Mapping, device) -> InstancedAS:
    """``tpu_raytracing.bvh.tlas.InstancedAS`` as a mapping of numpy arrays
    (``rows``, ``root``, ``root_count`` of its ``trav``;
    ``inv_transforms``; ``blas_entry``) -> the port's ``InstancedAS``."""
    return InstancedAS(
        trav=traversal_from_numpy(fields["rows"], fields["root"], fields["root_count"],
                                  device),
        inv_transforms=_t(np.asarray(fields["inv_transforms"], np.float32), device),
        blas_entry=_t(np.asarray(fields["blas_entry"], np.int32), device))


def instanced_split_from_numpy(fields: Mapping, device) -> InstancedSplitAS:
    """``tpu_raytracing.trace.instanced_split.InstancedSplitAS`` as a
    mapping of numpy arrays (``views``, the reference's ``(inner_i,
    inner_v, pairs_f)``; ``rows``, its ``packed`` rows; ``wmin``, ``wmax``,
    ``inv_transforms``) -> the port's, with K1's views of the BLAS as
    ``split_views_from_numpy`` makes them."""
    return InstancedSplitAS(
        views=split_views_from_numpy(*fields["views"], device),
        packed=packed_from_numpy(fields["rows"], device),
        wmin=_t(np.asarray(fields["wmin"], np.float32), device),
        wmax=_t(np.asarray(fields["wmax"], np.float32), device),
        inv_transforms=_t(np.asarray(fields["inv_transforms"], np.float32), device))


def bfs_views_from_numpy(inner_i, pair_rows, leaf_width: int, device) -> BFSViews:
    """``tpu_raytracing.trace.wavefront_bfs.BFSViews`` (its ``inner_i``
    [icap, w*8] int32 rows, ``pair_rows`` [P, 16] and ``leaf_width``) ->
    the port's ``BFSViews``; the reference's ``inner_f`` is the same rows
    bit-cast, which the port reads from ``inner``."""
    inner = np.asarray(inner_i, np.int32)
    return BFSViews(inner=_t(inner.reshape(inner.shape[0], -1, 8), device),
                    pair_rows=_t(np.asarray(pair_rows, np.int32), device),
                    leaf_width=int(leaf_width))


def instanced_grid_from_numpy(fields: Mapping, device) -> InstancedGridAS:
    """``tpu_raytracing.trace.grid_instanced.InstancedGridAS`` as a mapping
    (``blas_grid``, a mapping as ``grid_from_numpy`` takes it; ``inst_min``,
    ``inst_max``, ``inv_transforms``) -> the port's ``InstancedGridAS``."""
    return InstancedGridAS(
        blas_grid=grid_from_numpy(fields["blas_grid"], device),
        **{k: _t(np.asarray(fields[k], np.float32), device)
           for k in ("inst_min", "inst_max", "inv_transforms")})
