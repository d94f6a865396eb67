"""Render and build mode enums (reference: src/Arguments.h:8-26).

Port of ``tpu_raytracing/trace/modes.py`` (whole module).
"""

from __future__ import annotations

import enum


class RenderType(enum.IntEnum):
    DEPTH = 0
    BOX_TESTS = 1
    TRIANGLE_TESTS = 2
    MATERIAL_ID = 3
    LODS = 4
    DIFFUSE = 5
    TEXTURE = 6
    TEXTURE_LIT = 7
    TEXTURE_LIT_SHADOWS = 8
    COUNT = 9


class BuildType(enum.Enum):
    SAH = "sah"
    BOTTOM_UP = "bottom-up"
    HYBRID = "hybrid"
