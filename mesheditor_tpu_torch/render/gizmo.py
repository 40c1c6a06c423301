"""Transform + orientation gizmo math (reference: src/gizmo/TransformGizmo.{h,cpp},
src/gizmo/OrientationGizmo.h — Blender-alike handles, README.md:20-21).

Headless: the math that turns a mouse ray and a grabbed handle into a constrained
transform delta. A caller renders the handles however it likes (the debug-draw
overlay works), hit-tests with `pick_handle`, then drives a drag with
`GizmoDrag.update(ray)` — returning a new Transform each move, which callers wrap
in a SetTransform action (the reference's gesture-accumulated Update actions).

Counterpart of mesheditor_tpu/render/gizmo.py: host numpy, projecting on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..scene.components import Transform
from .camera import Camera

_AXES = np.eye(3)


def ray_through_pixel(camera: Camera, width: int, height: int, x: float, y: float):
    """(origin, unit direction) of the camera ray through a pixel center."""
    from .camera import view_projection

    inv = np.linalg.inv(view_projection(camera, width, height))
    ndc = np.array([(x + 0.5) / width * 2 - 1, 1 - (y + 0.5) / height * 2])
    near = inv @ np.array([ndc[0], ndc[1], -1.0, 1.0])
    far = inv @ np.array([ndc[0], ndc[1], 1.0, 1.0])
    near = near[:3] / near[3]
    far = far[:3] / far[3]
    d = far - near
    return near, d / np.linalg.norm(d)


def _closest_params(o1, d1, o2, d2):
    """(t1, t2) minimizing |o1 + t1 d1 - (o2 + t2 d2)|."""
    r = o1 - o2
    a = d1 @ d1
    b = d1 @ d2
    c = d2 @ d2
    d = d1 @ r
    e = d2 @ r
    den = a * c - b * b
    if abs(den) < 1e-12:
        return 0.0, (e / c if c > 0 else 0.0)
    t1 = (b * e - c * d) / den
    t2 = (a * e - b * d) / den
    return t1, t2


def _ray_plane(origin, direction, p0, n):
    dn = direction @ n
    if abs(dn) < 1e-9:
        return None
    t = (p0 - origin) @ n / dn
    return origin + t * direction if t > 0 else None


@dataclass
class Handle:
    """One gizmo handle: mode in {translate, rotate, scale}, axis 0..2, or
    plane handles (translate only, axis = plane normal index)."""

    mode: str
    axis: int
    plane: bool = False


def handle_points(center, size: float = 1.0) -> dict:
    """World positions used for hit-testing/rendering: axis tips, plane pads,
    rotation circle radii (the gizmo's geometry contract)."""
    center = np.asarray(center, np.float64)
    tips = {i: center + _AXES[i] * size for i in range(3)}
    pads = {i: center + (np.sum(_AXES, 0) - _AXES[i]) * size * 0.35 for i in range(3)}
    return {"tips": tips, "pads": pads, "radius": size * 0.8}


def pick_handle(camera: Camera, width: int, height: int, x: float, y: float,
                center, mode: str, size: float = 1.0,
                pixel_threshold: float = 8.0) -> Handle | None:
    """Hit-test the gizmo at pixel (x, y): nearest axis line / plane pad / rotation
    circle within the pixel threshold (the GPU-pick analog for gizmo handles)."""
    from .raster import project_points, screen_coords
    from .camera import view_projection

    center = np.asarray(center, np.float64)
    mvp = view_projection(camera, width, height)

    def to_px(p):
        clip = project_points(mvp, np.asarray(p, np.float64).reshape(-1, 3),
                              device="cpu").numpy()
        return screen_coords(clip, width, height)

    mouse = np.array([x, y], np.float64)
    best = None
    best_d = pixel_threshold
    if mode in ("translate", "scale"):
        geo = handle_points(center, size)
        c_px = to_px(center)[0]
        for i in range(3):
            tip_px = to_px(geo["tips"][i])[0]
            d = _point_segment_px(mouse, c_px, tip_px)
            if d < best_d:
                best, best_d = Handle(mode, i), d
        if mode == "translate":
            for i in range(3):
                pad_px = to_px(geo["pads"][i])[0]
                d = np.linalg.norm(mouse - pad_px)
                if d < best_d:
                    best, best_d = Handle(mode, i, plane=True), d
    elif mode == "rotate":
        r = handle_points(center, size)["radius"]
        for i in range(3):
            u, v = _AXES[(i + 1) % 3], _AXES[(i + 2) % 3]
            ang = np.linspace(0, 2 * np.pi, 48, endpoint=False)
            ring = center + r * (np.outer(np.cos(ang), u) + np.outer(np.sin(ang), v))
            px = to_px(ring)
            d = np.linalg.norm(px - mouse, axis=1).min()
            if d < best_d:
                best, best_d = Handle(mode, i), d
    return best


def _point_segment_px(p, a, b):
    ab = b - a
    t = np.clip((p - a) @ ab / max(ab @ ab, 1e-12), 0.0, 1.0)
    return float(np.linalg.norm(p - (a + t * ab)))


@dataclass
class GizmoDrag:
    """One drag gesture: constructed at mouse-down with the grabbed handle, fed
    mouse rays while dragging; every update returns the new Transform (the gesture
    accumulation of the reference's SelectedDelta scope, action/Dispatch.h:175-210)."""

    handle: Handle
    start_transform: Transform
    start_ray: tuple  # (origin, dir) at mouse-down

    def __post_init__(self):
        self._center = np.asarray(self.start_transform.translation, np.float64)
        o, d = self.start_ray
        ax = _AXES[self.handle.axis]
        if self.handle.mode == "translate" and not self.handle.plane:
            t_ray, t_axis = _closest_params(np.asarray(o), np.asarray(d),
                                            self._center, ax)
            self._start_s = t_axis
        elif self.handle.mode == "translate":
            hit = _ray_plane(np.asarray(o), np.asarray(d), self._center, ax)
            self._start_p = hit if hit is not None else self._center
        elif self.handle.mode == "rotate":
            self._start_angle = self._angle_on_plane(o, d)
        else:  # scale
            t_ray, t_axis = _closest_params(np.asarray(o), np.asarray(d),
                                            self._center, ax)
            self._start_s = t_axis if abs(t_axis) > 1e-9 else 1e-9

    def _angle_on_plane(self, o, d):
        ax = _AXES[self.handle.axis]
        hit = _ray_plane(np.asarray(o), np.asarray(d), self._center, ax)
        if hit is None:
            return 0.0
        rel = hit - self._center
        u, v = _AXES[(self.handle.axis + 1) % 3], _AXES[(self.handle.axis + 2) % 3]
        return float(np.arctan2(rel @ v, rel @ u))

    def update(self, ray) -> Transform:
        """New Transform for the current mouse ray."""
        o, d = (np.asarray(r, np.float64) for r in ray)
        t = self.start_transform
        ax = _AXES[self.handle.axis]
        if self.handle.mode == "translate" and not self.handle.plane:
            _, t_axis = _closest_params(o, d, self._center, ax)
            delta = (t_axis - self._start_s) * ax
            return replace(t, translation=np.asarray(t.translation) + delta)
        if self.handle.mode == "translate":
            hit = _ray_plane(o, d, self._center, ax)
            if hit is None:
                return t
            return replace(t, translation=np.asarray(t.translation)
                           + (hit - self._start_p))
        if self.handle.mode == "rotate":
            angle = self._angle_on_plane(o, d) - self._start_angle
            half = angle / 2.0
            dq = np.array([np.cos(half), *(np.sin(half) * ax)])
            w1, x1, y1, z1 = dq
            w2, x2, y2, z2 = np.asarray(t.rotation, np.float64)
            rot = np.array([
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ])
            return replace(t, rotation=rot)
        # scale: ratio of axis parameters
        _, t_axis = _closest_params(o, d, self._center, ax)
        ratio = t_axis / self._start_s if abs(self._start_s) > 1e-12 else 1.0
        s = np.asarray(t.scale, np.float64).copy()
        s[self.handle.axis] *= max(ratio, 1e-6)
        return replace(t, scale=s)


def orientation_axes(camera: Camera) -> dict:
    """The corner orientation gizmo (OrientationGizmo.h): screen-space 2D directions
    of the world ±XYZ axes under the current view, unit length, y-down pixels."""
    view = camera.view()
    out = {}
    for i, name in enumerate("xyz"):
        v = view[:3, :3] @ _AXES[i]
        d = np.array([v[0], -v[1]])
        n = np.linalg.norm(d)
        out[f"+{name}"] = d / n if n > 1e-9 else np.zeros(2)
        out[f"-{name}"] = -out[f"+{name}"]
    return out


def snap_view(camera: Camera, axis: str) -> Camera:
    """Camera looking down a world axis at the same target/distance (clicking an
    orientation-gizmo tip)."""
    target = np.asarray(camera.target, np.float64)
    dist = float(np.linalg.norm(np.asarray(camera.eye) - target))
    sign = -1.0 if axis.startswith("-") else 1.0
    i = "xyz".index(axis[-1])
    eye = target + sign * _AXES[i] * dist
    up = np.array([0.0, 1.0, 0.0]) if i != 1 else np.array([0.0, 0.0, -1.0 * sign])
    return Camera(eye=eye, target=target, up=up, fov_y=camera.fov_y,
                  near=camera.near, far=camera.far)
