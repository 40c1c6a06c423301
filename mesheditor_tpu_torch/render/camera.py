"""Camera math (reference: src/Camera.h, src/viewport/ViewCamera*).

Right-handed, Y-up world; view looks down -Z; GL-style clip space (z in [-1, 1]).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World -> view matrix."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    f = target - eye
    f = f / max(np.linalg.norm(f), 1e-30)
    s = np.cross(f, up)
    sn = np.linalg.norm(s)
    if sn < 1e-12:  # looking along up: pick any orthogonal right vector
        alt = np.array([1.0, 0.0, 0.0]) if abs(f[0]) < 0.9 else np.array([0.0, 0.0, 1.0])
        s = np.cross(f, alt)
        sn = np.linalg.norm(s)
    s = s / sn
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = f @ eye
    return m


def perspective(fov_y_rad: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Perspective projection, GL clip conventions (z_ndc in [-1, 1])."""
    t = 1.0 / np.tan(fov_y_rad / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


@dataclass
class Camera:
    """Orbit camera (reference: src/viewport/ViewCamera, Blender-alike navigation)."""

    eye: np.ndarray = field(default_factory=lambda: np.array([2.0, 1.5, 3.0]))
    target: np.ndarray = field(default_factory=lambda: np.zeros(3))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    fov_y: float = np.deg2rad(50.0)
    near: float = 0.01
    far: float = 100.0

    def view(self) -> np.ndarray:
        return look_at(self.eye, self.target, self.up)

    def projection(self, aspect: float) -> np.ndarray:
        return perspective(self.fov_y, aspect, self.near, self.far)


def view_projection(camera: Camera, width: int, height: int) -> np.ndarray:
    return camera.projection(width / max(height, 1)) @ camera.view()


def orbit_camera(center, radius: float, azimuth_deg: float = -60.0,
                 elevation_deg: float = 25.0, **kw) -> Camera:
    """Camera orbiting `center` at `radius` — the viz.py view convention."""
    center = np.asarray(center, np.float64)
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    eye = center + radius * np.array(
        [np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)]
    )
    near = max(radius * 1e-3, 1e-4)
    return Camera(eye=eye, target=center, near=near, far=max(radius * 20, 10 * near), **kw)


def frame_points(points: np.ndarray, margin: float = 1.35, **kw) -> Camera:
    """Orbit camera framing a point cloud (the reference's focus-selected behavior)."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if points.size == 0:
        return orbit_camera(np.zeros(3), 3.0, **kw)
    lo, hi = points.min(axis=0), points.max(axis=0)
    center = (lo + hi) / 2
    r = float(np.linalg.norm(hi - lo)) / 2 or 1.0
    cam = orbit_camera(center, radius=margin * r / np.tan(np.deg2rad(25.0)), **kw)
    return cam
