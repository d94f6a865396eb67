"""Yaw/pitch fly camera (reference: src/Camera.cu, src/Camera.cuh:7-15).

Port of ``tpu_raytracing/scene/camera.py`` (whole module). The host math is
a numpy copy of the reference's; ``camera_to_device`` returns torch
tensors on an explicit device. Semantics match the reference exactly so identical scenes produce
pixel-matched framebuffers: basis recompute from yaw/pitch
(src/Camera.cu:8-29), WASD/QE movement scaled by scene size (:31-45),
mouse-look deltas (:47-51), wheel zoom (:53-60) and scene-framing init
(:62-92).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Camera:
    position: np.ndarray
    pitch: float = 0.0
    yaw: float = 0.0
    w: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0, 0, 1], np.float32))
    u: np.ndarray = dataclasses.field(default_factory=lambda: np.array([-1, 0, 0], np.float32))
    v: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0, -1, 0], np.float32))
    scale: float = 1.0
    max_depth: float = 1.0


def _normalize(a: np.ndarray) -> np.ndarray:
    return (a / np.linalg.norm(a)).astype(np.float32)


def update_camera(camera: Camera) -> Camera:
    """Recompute the u/v/w basis from yaw/pitch (src/Camera.cu:8-29).

    Note v = cross(w, u) points *down* for the identity pose — image rows
    therefore grow downward, matching the reference's framebuffer layout.
    """
    if camera.pitch > math.pi / 2:
        camera.pitch = float(math.pi / 2 - 0.0001)
    elif camera.pitch < -math.pi / 2:
        camera.pitch = float(-math.pi / 2 + 0.0001)

    pitch, yaw = camera.pitch, camera.yaw
    w = np.array(
        [-math.sin(yaw) * math.cos(pitch), -math.sin(pitch), math.cos(yaw) * math.cos(pitch)],
        np.float32,
    )
    camera.w = _normalize(w)
    camera.u = _normalize(np.cross(camera.w, np.array([0, 1, 0], np.float32)))
    camera.v = _normalize(np.cross(camera.w, camera.u))
    return camera


def update_camera_position(camera: Camera, keys: set) -> Camera:
    """WASD/QE/space movement (src/Camera.cu:31-45)."""
    step = camera.scale * 0.25
    if "w" in keys:
        camera.position = camera.position + camera.w * step
    if "s" in keys:
        camera.position = camera.position - camera.w * step
    if "a" in keys:
        camera.position = camera.position - camera.u * step
    if "d" in keys:
        camera.position = camera.position + camera.u * step
    if "q" in keys or " " in keys:
        camera.position = camera.position - camera.v * step
    if "e" in keys:
        camera.position = camera.position + camera.v * step
    return camera


def update_camera_look_delta(camera: Camera, dx: float, dy: float) -> Camera:
    """Mouse-look (src/Camera.cu:47-51)."""
    camera.yaw += dx * 0.01
    camera.pitch += dy * 0.01
    return camera


def update_camera_zoom(camera: Camera, direction: int) -> Camera:
    """Wheel zoom (src/Camera.cu:53-60)."""
    if direction > 0:
        camera.position = camera.position + camera.w * camera.scale
    else:
        camera.position = camera.position - camera.w * camera.scale
    return camera


def initialise_camera(aabb_min: np.ndarray, aabb_max: np.ndarray) -> Camera:
    """Frame the scene AABB (src/Camera.cu:62-92): position at the AABB
    centre, yaw = pi/2, scale = z-extent / 10, max_depth = 1.5x the largest
    extent."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    centre = (aabb_max + aabb_min) * 0.5
    length = aabb_max - aabb_min
    camera = Camera(position=centre.astype(np.float32))
    camera.scale = float(length[2]) / 10.0
    camera.max_depth = float(max(length[0], max(length[1], length[2]))) * 1.5
    camera.yaw = math.pi / 2
    return update_camera(camera)


def camera_to_device(camera: Camera, device) -> dict:
    """Device view of the camera used by ray generation (float32 tensors)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {
        "position": f32(camera.position),
        "u": f32(camera.u),
        "v": f32(camera.v),
        "w": f32(camera.w),
        "max_depth": f32(camera.max_depth),
    }
