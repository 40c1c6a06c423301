"""Rigid-body physics types, aligned with KHR_physics_rigid_bodies semantics.

Mirrors the reference's surface (src/physics/PhysicsTypes.h:25-145, PhysicsContact.h:9-67):
materials with combine modes, collision filters, primitive shapes, motion properties, and
— the part that matters to the audio pipeline — the ContactImpact / SustainedContact
reporting stream, which is the excitation bus feeding modal synthesis.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class CombineMode(Enum):
    AVERAGE = "average"
    MINIMUM = "minimum"
    MAXIMUM = "maximum"
    MULTIPLY = "multiply"


@dataclass(frozen=True)
class PhysicsMaterial:
    static_friction: float = 0.5
    dynamic_friction: float = 0.5
    restitution: float = 0.3
    friction_combine: CombineMode = CombineMode.AVERAGE
    restitution_combine: CombineMode = CombineMode.AVERAGE


def combine(a: float, b: float, mode: CombineMode) -> float:
    if mode == CombineMode.MINIMUM:
        return min(a, b)
    if mode == CombineMode.MAXIMUM:
        return max(a, b)
    if mode == CombineMode.MULTIPLY:
        return a * b
    return 0.5 * (a + b)


@dataclass(frozen=True)
class CollisionFilter:
    """Bitmask collision system (reference: PhysicsTypes.h:48-53)."""

    membership: int = 1
    collides_with: int = ~0


@dataclass(frozen=True)
class ShapeSphere:
    radius: float = 0.5


@dataclass(frozen=True)
class ShapeBox:
    half_extents: tuple = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class ShapeCapsule:
    """Capsule along local +Y: segment of `half_height` each way, swept by `radius`
    (reference: PhysicsTypes.h shape set; also the virtual striker mallet,
    src/audio/ContactModel.h:36-41)."""

    radius: float = 0.25
    half_height: float = 0.5


@dataclass(frozen=True)
class ShapeCylinder:
    """Cylinder along local +Y. Collides through an n-gon prism hull proxy (documented
    approximation); mass/inertia use the exact cylinder closed forms."""

    radius: float = 0.5
    half_height: float = 0.5
    segments: int = 16


@dataclass(eq=False)
class ShapeConvexHull:
    """Convex hull of a point cloud (reference: PhysicsTypes.h:92-120 ConvexHull).
    Collides as the hull's triangulated surface (a dynamic mesh solid)."""

    points: object  # (n, 3) float array, shape-local


@dataclass(frozen=True)
class ShapePlane:
    """Static infinite plane: normal * x = offset."""

    normal: tuple = (0.0, 1.0, 0.0)
    offset: float = 0.0


@dataclass(eq=False)
class ShapeMesh:
    """Static triangle-mesh scenery (reference: Jolt MeshShape for static geometry).
    Collision queries run against a lazily built BVH (mesh/bvh.py closest-point);
    only static bodies may carry it — dynamic mesh-vs-mesh is out of scope."""

    positions: object  # (n, 3) float array, shape-local
    triangles: object  # (t, 3) int array

    def bvh(self):
        if getattr(self, "_bvh", None) is None:
            import numpy as np

            from ..mesh.bvh import build_bvh

            self._bvh = build_bvh(
                np.asarray(self.positions, np.float64),
                np.asarray(self.triangles, np.int64),
            )
        return self._bvh


@dataclass
class PhysicsMotion:
    """Motion properties (reference: PhysicsTypes.h:135-145)."""

    is_kinematic: bool = False
    mass: float = 1.0  # <= 0 derives from shape volume * 1000 kg/m^3
    linear_damping: float = 0.02
    angular_damping: float = 0.05
    gravity_factor: float = 1.0


BodyHandle = int


@dataclass
class ContactImpact:
    """One new impact (reference: PhysicsContact.h:14-25)."""

    body_a: BodyHandle
    body_b: BodyHandle
    point: np.ndarray  # world
    direction: np.ndarray  # unit, pointing into body_a
    impulse: float  # kg*m/s
    speed: float  # approach speed, m/s
    other_inv_mass: float  # kg^-1


@dataclass
class SustainedContact:
    """A persisting manifold, level-triggered: present while touching
    (reference: PhysicsContact.h:31-67)."""

    contact_id: int  # stable across steps for one (a, b) pair
    body_a: BodyHandle
    body_b: BodyHandle
    point: np.ndarray
    normal: np.ndarray  # unit, from b into a
    normal_force: float  # N
    slip_speed: float  # relative tangential speed at the contact, m/s
    sweep_speed_a: float  # contact point travel over body a's surface, m/s
    sweep_speed_b: float
    friction: float
    restitution: float
    step: int = 0  # the simulation step this report belongs to
