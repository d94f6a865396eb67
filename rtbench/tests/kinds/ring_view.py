"""A camera for the registry's tests, written into a copy of the
benchmark as ``rtbench/cameras/ring_view.py``: aimed at the world box's
centre from 0.7 of its size away, pitched 0.5 rad down, orbiting it."""

import math

import numpy as np

from rtbench import reference

PITCH = 0.5


def pose(aabb_min, aabb_max, step: int, period: int) -> dict:
    theta = 2.0 * math.pi * step / period
    lo, hi = np.asarray(aabb_min, np.float64), np.asarray(aabb_max, np.float64)
    size = float(np.max(hi - lo))
    w = np.array([math.sin(theta) * math.cos(PITCH), -math.sin(PITCH),
                  math.cos(theta) * math.cos(PITCH)])
    return reference.camera((lo + hi) / 2 - 0.7 * size * w, -theta, PITCH, 4.0 * size)
