"""The aerial orbit: bench.py's camera above the scene, turned about the
vertical axis through the cycle. A traffic mix names it by this file's
name (``"camera": "aerial_orbit"``)."""

import math

import numpy as np

from rtbench import reference


def pose(aabb_min, aabb_max, step: int, period: int) -> dict:
    """The aerial view of the 1M terrain runs: above the scene at
    1.5 x its top + 20, back at 0.7 x its near edge, pitched 0.7 rad down,
    orbited about the vertical axis by 2 pi / period a step and facing the
    vertical axis."""
    theta = 2.0 * math.pi * step / period
    y = float(aabb_max[1]) * 1.5 + 20.0
    z0 = float(aabb_min[2]) * 0.7
    pos = (z0 * math.sin(theta), y, z0 * math.cos(theta))
    return reference.camera(pos, -theta, 0.7,
                            1.5 * float(np.max(np.asarray(aabb_max) - aabb_min)))
