"""The scene registry, its components, the action system with its log and snapshots, and
the scene-reactive audio (counterpart of mesheditor_tpu/scene)."""

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
from .actions import (
    Action,
    ActionError,
    apply_action,
    clamp_field,
    FIELD_LIMITS,
    AddObject,
    RemoveObject,
    SetField,
    SetTransform,
    SetParent,
    SetAcousticMaterial,
    SetModalModel,
    StrikeVertex,
    SilenceObject,
    SetFundamental,
    SetT60Scale,
    SetGain,
)
from .log import ActionLog, replay
from .snapshot import snapshot_scene, restore_scene, verify_coverage

__all__ = [
    "Registry", "Entity",
    "Name", "SceneNode", "Transform", "WorldTransform", "MeshSurface",
    "AcousticMaterialRef", "SolveSettingsComponent", "ModalModel",
    "ModalGainComponent", "ModalTuningComponent", "SoundVertices", "ExciteState",
    "PERSISTENT_COMPONENTS", "DERIVED_COMPONENTS",
    "Action", "ActionError", "apply_action", "clamp_field", "FIELD_LIMITS",
    "AddObject", "RemoveObject", "SetField", "SetTransform", "SetParent",
    "SetAcousticMaterial", "SetModalModel", "StrikeVertex", "SilenceObject",
    "SetFundamental", "SetT60Scale", "SetGain",
    "ActionLog", "replay",
    "snapshot_scene", "restore_scene", "verify_coverage",
]
