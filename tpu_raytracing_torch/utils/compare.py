"""Image comparison metrics (SURVEY.md §4).

A copy of the JAX package's ``tpu_raytracing/utils/compare.py`` (``psnr``,
``pixel_match_fraction``): the module is numpy only, but the port imports
nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB; inf when identical."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def pixel_match_fraction(a: np.ndarray, b: np.ndarray, tol: int = 0) -> float:
    """Fraction of pixels whose every channel differs by <= tol."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    ok = np.all(np.abs(a - b) <= tol, axis=-1)
    return float(np.mean(ok))
