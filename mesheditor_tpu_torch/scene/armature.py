"""Armature: bone hierarchies, skins, pose evaluation, linear-blend skinning.

Mirrors the reference's armature data model (src/armature/ArmatureComponents.h:14-52):
bones with rest transforms and parents, skins binding mesh vertices to bones with weights
(glTF JOINTS_0/WEIGHTS_0 style), pose state composing down the chain, and the deform step
producing skinned positions — the GPU deform ranges of the reference become one batched
einsum here (vectorized, device-ready if handed jnp arrays).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _trs(translation, rotation_wxyz, scale) -> np.ndarray:
    w, x, y, z = rotation_wxyz
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(scale)[None, :]
    m[:3, 3] = translation
    return m


@dataclass
class Bone:
    name: str = ""
    parent: int = -1  # index into Armature.bones, -1 = root
    rest_translation: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rest_rotation: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    rest_scale: np.ndarray = field(default_factory=lambda: np.ones(3))


@dataclass
class Pose:
    """Per-bone local TRS overrides; identity entries keep the rest pose."""

    translation: np.ndarray  # (B, 3)
    rotation: np.ndarray  # (B, 4) wxyz
    scale: np.ndarray  # (B, 3)

    @staticmethod
    def rest(num_bones: int) -> "Pose":
        return Pose(
            np.zeros((num_bones, 3)),
            np.tile(np.array([1.0, 0, 0, 0]), (num_bones, 1)),
            np.ones((num_bones, 3)),
        )


@dataclass
class Armature:
    bones: list[Bone] = field(default_factory=list)

    def add_bone(self, name="", parent=-1, translation=(0, 0, 0),
                 rotation=(1, 0, 0, 0), scale=(1, 1, 1)) -> int:
        if parent >= len(self.bones):
            raise ValueError("parent must precede child")
        self.bones.append(Bone(name, parent,
                               np.asarray(translation, np.float64),
                               np.asarray(rotation, np.float64),
                               np.asarray(scale, np.float64)))
        return len(self.bones) - 1

    def rest_world(self) -> np.ndarray:
        """(B, 4, 4) bone-to-armature rest transforms."""
        out = np.zeros((len(self.bones), 4, 4))
        for i, b in enumerate(self.bones):
            local = _trs(b.rest_translation, b.rest_rotation, b.rest_scale)
            out[i] = out[b.parent] @ local if b.parent >= 0 else local
        return out

    def pose_world(self, pose: Pose) -> np.ndarray:
        """(B, 4, 4) posed bone-to-armature transforms: pose TRS composed on the rest
        local transform, down the parent chain (bones are parent-before-child)."""
        out = np.zeros((len(self.bones), 4, 4))
        for i, b in enumerate(self.bones):
            rest_local = _trs(b.rest_translation, b.rest_rotation, b.rest_scale)
            pose_local = _trs(pose.translation[i], pose.rotation[i], pose.scale[i])
            local = rest_local @ pose_local
            out[i] = out[b.parent] @ local if b.parent >= 0 else local
        return out


@dataclass
class Skin:
    """Vertex-to-bone binding: up to 4 influences per vertex (glTF style)."""

    joints: np.ndarray  # (V, 4) int bone indices
    weights: np.ndarray  # (V, 4) float, rows sum to 1 where bound
    inverse_bind: np.ndarray  # (B, 4, 4) armature-space -> bone-space at bind time

    @staticmethod
    def bind(armature: Armature, joints, weights) -> "Skin":
        rest = armature.rest_world()
        return Skin(
            np.asarray(joints, np.int64),
            np.asarray(weights, np.float64),
            np.linalg.inv(rest),
        )


def skin_positions(skin: Skin, bone_world: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Linear-blend skinning: x' = sum_j w_j * (M_j @ inv_bind_j) @ x, batched."""
    positions = np.asarray(positions, np.float64).reshape(-1, 3)
    mats = bone_world @ skin.inverse_bind  # (B, 4, 4)
    hom = np.concatenate([positions, np.ones((positions.shape[0], 1))], axis=1)  # (V, 4)
    per_joint = mats[skin.joints]  # (V, 4, 4, 4)
    moved = np.einsum("vjab,vb->vja", per_joint, hom)  # (V, 4, 4)
    blended = (skin.weights[:, :, None] * moved).sum(axis=1)  # (V, 4)
    return blended[:, :3]


# ---- ECS wiring (reference: armature/ArmatureComponents.h:14-52 — bones, skins,
# pose state, GPU deform ranges; deformation runs in the frame pipeline before draw) --


@dataclass
class ArmatureComponent:
    """An armature + its current pose, carried by an entity. Persistent: bones and
    pose are authored state; the deformed surface is Derived."""

    armature: Armature = field(default_factory=Armature)
    pose: Pose = field(default_factory=lambda: Pose.rest(0))


@dataclass
class SkinComponent:
    """Binds this entity's MeshSurface to an armature entity's bones."""

    armature_entity: int = 0
    joints: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.int64))
    weights: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))
    inverse_bind: np.ndarray = field(default_factory=lambda: np.zeros((0, 4, 4)))


@dataclass
class DeformedSurface:
    """Derived: skinned vertex positions, rebuilt by the derivation pass; the
    renderer and physics prefer these over the rest-pose MeshSurface positions."""

    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))


def derive_skinning(registry) -> None:
    """Apply linear-blend skinning for every skinned mesh (the deform stage of
    ProcessComponentEvents, reference src/ProcessEvents.cpp:~1076-1200)."""
    from .components import MeshSurface

    for e, sc in list(registry.view(SkinComponent)):
        surf = registry.get(e, MeshSurface)
        arm = registry.get(sc.armature_entity, ArmatureComponent)
        if surf is None or arm is None or surf.positions.shape[0] == 0:
            continue
        if sc.joints.shape[0] != surf.positions.shape[0]:
            continue
        bone_world = arm.armature.pose_world(arm.pose)
        skin = Skin(np.asarray(sc.joints, np.int64),
                    np.asarray(sc.weights, np.float64),
                    np.asarray(sc.inverse_bind, np.float64))
        deformed = skin_positions(skin, bone_world, surf.morphed_positions())
        registry.emplace(e, DeformedSurface(positions=deformed))


def make_skin_component(armature_entity: int, armature: Armature, joints,
                        weights) -> SkinComponent:
    """Bind helper mirroring Skin.bind, but ECS-addressed."""
    rest = armature.rest_world()
    return SkinComponent(
        armature_entity=int(armature_entity),
        joints=np.asarray(joints, np.int64),
        weights=np.asarray(weights, np.float64),
        inverse_bind=np.linalg.inv(rest),
    )
