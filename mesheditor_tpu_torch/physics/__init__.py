"""Physics types and the physics -> audio bridge (counterpart of mesheditor_tpu/physics;
the rigid-body world itself is not ported yet)."""

from .types import (
    BodyHandle,
    CollisionFilter,
    ContactImpact,
    PhysicsMaterial,
    PhysicsMotion,
    ShapeBox,
    ShapeMesh,
    ShapePlane,
    ShapeSphere,
    SustainedContact,
)
from .bridge import AudioContactBridge

__all__ = [
    "BodyHandle",
    "CollisionFilter",
    "ContactImpact",
    "PhysicsMaterial",
    "PhysicsMotion",
    "ShapeBox",
    "ShapeMesh",
    "ShapePlane",
    "ShapeSphere",
    "SustainedContact",
    "AudioContactBridge",
]
