"""The rigid-body world, its types and the physics -> audio bridge (counterpart of
mesheditor_tpu/physics)."""

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
from .world import PhysicsWorld
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
    "PhysicsWorld",
    "AudioContactBridge",
]
