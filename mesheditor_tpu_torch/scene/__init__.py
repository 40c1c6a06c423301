"""The scene registry, its components and the scene-reactive audio (counterpart of
mesheditor_tpu/scene; actions, the action log and snapshots are not ported yet)."""

from .registry import Registry, Entity
from .components import (
    Name,
    SceneNode,
    Transform,
    WorldTransform,
    MeshSurface,
    AcousticMaterialRef,
    SolveSettingsComponent,
    ModalModel,
    ModalGainComponent,
    ModalTuningComponent,
    SoundVertices,
    ExciteState,
    PERSISTENT_COMPONENTS,
    DERIVED_COMPONENTS,
)

__all__ = [
    "Registry", "Entity",
    "Name", "SceneNode", "Transform", "WorldTransform", "MeshSurface",
    "AcousticMaterialRef", "SolveSettingsComponent", "ModalModel",
    "ModalGainComponent", "ModalTuningComponent", "SoundVertices", "ExciteState",
    "PERSISTENT_COMPONENTS", "DERIVED_COMPONENTS",
]
