"""Instantiate a PhysicsWorld from a scene Registry's rigid-body components.

The analog of the reference's node→Jolt conversion (GltfScene.cpp:1743-1775 creates
PhysicsMotion/ColliderShape components; the physics system builds bodies from them):
entities carrying RigidBodyComponent become world bodies at their Transform pose.
"""

from __future__ import annotations

import numpy as np

from ..scene.components import MeshSurface, RigidBodyComponent, Transform
from ..scene.registry import Registry
from .types import (PhysicsMotion, ShapeBox, ShapeCapsule, ShapeConvexHull,
                    ShapeCylinder, ShapeMesh, ShapePlane, ShapeSphere)
from .world import PhysicsWorld


def _shape_of(rb: RigidBodyComponent, surface: MeshSurface | None):
    if rb.shape_kind == "box":
        return ShapeBox(half_extents=tuple(float(v) for v in rb.half_extents))
    if rb.shape_kind == "capsule":
        return ShapeCapsule(radius=float(rb.radius), half_height=float(rb.half_height))
    if rb.shape_kind == "cylinder":
        return ShapeCylinder(radius=float(rb.radius), half_height=float(rb.half_height))
    if rb.shape_kind == "convex" and surface is not None and surface.positions.shape[0]:
        return ShapeConvexHull(points=np.asarray(surface.positions, np.float64))
    if rb.shape_kind == "plane":
        n = np.asarray(rb.plane_normal, np.float64)
        n = n / max(np.linalg.norm(n), 1e-30)
        return ShapePlane(normal=tuple(float(v) for v in n), offset=float(rb.plane_offset))
    if rb.shape_kind == "mesh" and surface is not None and surface.positions.shape[0]:
        return ShapeMesh(positions=np.asarray(surface.positions, np.float64),
                         triangles=np.asarray(surface.triangles, np.int64))
    return ShapeSphere(radius=float(rb.radius))


def build_world(registry: Registry, gravity=(0.0, -9.81, 0.0), dt: float = 1.0 / 240.0,
                report_contacts: bool = True):
    """PhysicsWorld + {entity: body handle} from every RigidBodyComponent."""
    world = PhysicsWorld(gravity=gravity, dt=dt)
    handles: dict[int, int] = {}
    for e, rb in sorted(registry.view(RigidBodyComponent)):
        t = registry.get(e, Transform)
        pos = t.translation if t is not None else np.zeros(3)
        quat = t.rotation if t is not None else np.array([1.0, 0, 0, 0])
        motion = PhysicsMotion(
            is_kinematic=bool(rb.is_kinematic),
            mass=float(rb.mass),
            gravity_factor=float(rb.gravity_factor),
        ) if rb.is_dynamic or rb.is_kinematic else None
        shape = _shape_of(rb, registry.get(e, MeshSurface))
        if isinstance(shape, ShapeMesh) and motion is not None:
            # The solver treats a body's position as its COM: center dynamic solids on
            # their volume centroid and shift the body pose to compensate.
            from .mass_props import mesh_mass_properties
            from .world import _quat_to_mat

            _, com, _ = mesh_mass_properties(shape.positions, shape.triangles)
            shape = ShapeMesh(positions=np.asarray(shape.positions) - com,
                              triangles=shape.triangles)
            pos = np.asarray(pos, np.float64) + _quat_to_mat(np.asarray(quat)) @ com
        h = world.add_body(
            shape, position=pos, quat=quat,
            motion=motion,
            report_contacts=report_contacts,
            static=not (rb.is_dynamic or rb.is_kinematic),
        )
        b = world.bodies[h]
        if rb.is_dynamic:
            b.vel = np.asarray(rb.linear_velocity, np.float64).copy()
            b.ang = np.asarray(rb.angular_velocity, np.float64).copy()
        handles[e] = h
    return world, handles


def write_back_poses(registry: Registry, world: PhysicsWorld, handles: dict) -> None:
    """Copy simulated body poses back onto the entities' Transforms."""
    for e, h in handles.items():
        b = world.bodies[h]
        t = registry.get(e, Transform) or Transform()
        t.translation = b.pos.copy()
        t.rotation = b.quat.copy()
        registry.emplace(e, t)
