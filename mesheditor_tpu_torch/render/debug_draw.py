"""Physics debug draw: collider wireframe overlays (reference:
src/physics/PhysicsDebugDraw.{h,cpp} — per-shape wireframes drawn over the scene).

Each body's shape expands to world-space line segments (sphere great circles, box
edges, capsule profile, hull/mesh edges, a plane grid patch); segments are projected
with the scene camera and composited over a rendered image host-side. Overlays draw
on top (no depth test), matching the reference's debug-layer behavior.

Counterpart of mesheditor_tpu/render/debug_draw.py: host numpy, projecting on the CPU.
"""

from __future__ import annotations

import numpy as np

from .camera import Camera, view_projection
from .raster import project_points, screen_coords


def _circle(center, u, v, radius, n=24):
    ang = np.linspace(0, 2 * np.pi, n + 1)
    pts = center + radius * (np.outer(np.cos(ang), u) + np.outer(np.sin(ang), v))
    return np.stack([pts[:-1], pts[1:]], axis=1)  # (n, 2, 3)


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def shape_segments(body) -> np.ndarray:
    """(s, 2, 3) world-space wireframe segments for one physics body."""
    from ..physics.types import (
        ShapeBox, ShapeCapsule, ShapeMesh, ShapePlane, ShapeSphere,
    )

    r = _quat_to_mat(np.asarray(body.quat, np.float64))
    pos = np.asarray(body.pos, np.float64)
    shape = body.shape
    ex, ey, ez = r[:, 0], r[:, 1], r[:, 2]
    segs = []
    if isinstance(shape, ShapeSphere):
        for (u, v) in ((ex, ey), (ey, ez), (ez, ex)):
            segs.append(_circle(pos, u, v, shape.radius))
    elif isinstance(shape, ShapeCapsule):
        h = shape.half_height
        for (u, v) in ((ex, ez),):
            segs.append(_circle(pos + ey * h, u, v, shape.radius))
            segs.append(_circle(pos - ey * h, u, v, shape.radius))
        for d in (ex, -ex, ez, -ez):
            a = pos + ey * h + d * shape.radius
            b = pos - ey * h + d * shape.radius
            segs.append(np.array([[a, b]]))
        for (u, v) in ((ex, ey), (ez, ey)):
            segs.append(_circle(pos + ey * h, u, v, shape.radius, n=12)[:6])
            segs.append(_circle(pos - ey * h, u, -v, shape.radius, n=12)[:6])
    elif isinstance(shape, ShapeBox):
        he = np.asarray(shape.half_extents, np.float64)
        corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)]) * he
        world = pos + corners @ r.T
        edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
                 (0, 4), (1, 5), (2, 6), (3, 7)]
        segs.append(np.stack([[world[a], world[b]] for a, b in edges]))
    elif isinstance(shape, ShapePlane):
        n = np.asarray(shape.normal, np.float64)
        n = n / np.linalg.norm(n)
        alt = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0.0, 1, 0])
        u = np.cross(n, alt)
        u /= np.linalg.norm(u)
        v = np.cross(n, u)
        o = n * shape.offset
        grid = []
        for k in np.linspace(-2, 2, 9):
            grid.append([o + u * k + v * -2, o + u * k + v * 2])
            grid.append([o + v * k + u * -2, o + v * k + u * 2])
        segs.append(np.asarray(grid))
    elif isinstance(shape, ShapeMesh):
        pts = pos + np.asarray(shape.positions, np.float64) @ r.T
        tris = np.asarray(shape.triangles, np.int64)
        e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
        e = np.unique(np.sort(e, axis=1), axis=0)
        segs.append(np.stack([pts[e[:, 0]], pts[e[:, 1]]], axis=1))
    if not segs:
        return np.zeros((0, 2, 3))
    return np.concatenate(segs)


def world_segments(world) -> list:
    """[(handle, (s, 2, 3) segments)] for every body, deterministic order."""
    return [(h, shape_segments(world.bodies[h])) for h in sorted(world.bodies)]


def draw_segments(image: np.ndarray, segments: np.ndarray, camera: Camera,
                  color=(0.2, 0.95, 0.35)) -> np.ndarray:
    """Composite projected segments over a rendered image (returns a copy).
    Clipping: segments with an endpoint behind the camera are dropped (debug layer)."""
    img = np.array(image, copy=True)
    h, w = img.shape[:2]
    segments = np.asarray(segments, np.float64).reshape(-1, 2, 3)
    if segments.size == 0:
        return img
    mvp = view_projection(camera, w, h)
    flat = segments.reshape(-1, 3)
    clip = project_points(mvp, flat, device="cpu").numpy().astype(np.float64)
    ok = clip[:, 3] > 1e-6
    sc = screen_coords(clip, w, h).reshape(-1, 2, 2)
    ok = ok.reshape(-1, 2).all(axis=1)
    color = np.asarray(color, np.float64)
    for (a, b) in sc[ok]:
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        if n > 4 * max(w, h):  # off-screen runaway
            continue
        xs = np.linspace(a[0], b[0], n).round().astype(int)
        ys = np.linspace(a[1], b[1], n).round().astype(int)
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        img[ys[keep], xs[keep]] = color
    return img


def draw_physics_debug(image: np.ndarray, world, camera: Camera,
                       color=(0.2, 0.95, 0.35), contact_color=(1.0, 0.3, 0.2),
                       draw_contacts: bool = True) -> np.ndarray:
    """The DrawBodies + contact-points debug layer over a rendered frame."""
    img = np.array(image, copy=True)
    for _, segs in world_segments(world):
        img = draw_segments(img, segs, camera, color)
    if draw_contacts and getattr(world, "sustained", None):
        h, w = img.shape[:2]
        mvp = view_projection(camera, w, h)
        pts = np.asarray([c.point for c in world.sustained.values()], np.float64)
        if pts.size:
            clip = project_points(mvp, pts.reshape(-1, 3),
                                  device="cpu").numpy().astype(np.float64)
            sc = screen_coords(clip, w, h)
            for (x, y), cw in zip(sc, clip[:, 3]):
                if cw <= 1e-6:
                    continue
                xi, yi = int(round(x)), int(round(y))
                if 1 <= xi < w - 1 and 1 <= yi < h - 1:
                    img[yi - 1:yi + 2, xi - 1:xi + 2] = contact_color
    return img
