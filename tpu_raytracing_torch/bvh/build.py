"""Build dispatcher (reference: src/BuildWrapper.cu, src/BuildWrapper.cuh:6-20).

Port of ``tpu_raytracing/bvh/build.py`` (``build``,
``sah_memory_requirements``, ``bu_memory_requirements``): the three build
pipelines behind one call, and the reference's memory quotes, which report
the persistent device bytes of a build's outputs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_raytracing_torch.bvh import hybrid, lbvh, sah
from tpu_raytracing_torch.bvh.types import BVH, TrianglePairs
from tpu_raytracing_torch.trace.modes import BuildType


def build(triangles: torch.Tensor, build_type: BuildType = BuildType.SAH,
          enable_pairs: bool = False, enable_splits: bool = False,
          debug: bool = False) -> Tuple[BVH, TrianglePairs]:
    """RunSahBuild / RunBottomUpBuild (src/BuildWrapper.cu:140-362).

    ``enable_splits`` applies to the SAH pipeline only, as in the reference
    (the bottom-up pipeline never reads it, src/BuildWrapper.cu:253-362), and
    so does ``debug`` (the SAH build's invariants as host checks).
    """
    if build_type == BuildType.SAH:
        return sah.build_sah(triangles, enable_pairs, enable_splits, debug=debug)
    if build_type == BuildType.BOTTOM_UP:
        return lbvh.build_lbvh(triangles, enable_pairs=enable_pairs)
    if build_type == BuildType.HYBRID:
        return hybrid.build_hybrid(triangles, enable_pairs=enable_pairs)
    raise ValueError(f"unknown build type {build_type}")


def sah_memory_requirements(num_triangles: int) -> int:
    """Persistent bytes of an SAH build's outputs (cf. SahMemoryRequirements,
    src/BuildWrapper.cu:126-130): the node arena and the pair buffer, with
    the same 20% spatial-split headroom."""
    cap = num_triangles + max(num_triangles // 5, 1)
    node_bytes = (2 * cap + 2 * sah.NUM_BLOCKS + 2) * 32
    pair_bytes = cap * 64
    return node_bytes + pair_bytes


def bu_memory_requirements(num_triangles: int) -> int:
    """Persistent bytes of an LBVH build's outputs (cf. BuMemoryRequirements,
    src/BuildWrapper.cu:132-136)."""
    node_bytes = max(2 * (num_triangles - 1), 2) * 32
    pair_bytes = num_triangles * 64
    return node_bytes + pair_bytes
