"""The action system: every scene mutation flows through one typed action union.

The architectural invariant carried over from the reference (Architecture.md:3-5 via
SURVEY.md §1): user intent never mutates the registry outside an action's apply handler —
that is the load-bearing rule that makes the action log + snapshot replay deterministic.
Field edits clamp against a FieldLimits table (reference: src/action/Dispatch.h:63-106).

Counterpart of mesheditor_tpu/scene/actions.py, the same code but for the "plane"
primitive of AddPrimitive, which the reference cannot build (see apply_action).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Union

import numpy as np

from .components import (
    AcousticMaterialRef,
    ModalGainComponent,
    ModalModel,
    ModalTuningComponent,
    MeshSurface,
    Name,
    SceneNode,
    SolveSettingsComponent,
    SoundVertices,
    Transform,
)
from .registry import Entity, Registry


class ActionError(ValueError):
    pass


# (component type name, field name) -> (lo, hi). Mirrors the reference's audio limits
# (FieldLimits specializations, src/audio/AudioSystem.cpp:46-87).
FIELD_LIMITS: dict[tuple[str, str], tuple[float, float]] = {
    ("AcousticMaterialRef", "density"): (1.0, 30_000.0),
    ("AcousticMaterialRef", "young_modulus"): (1e6, 1e13),
    ("AcousticMaterialRef", "poisson_ratio"): (0.0, 0.49),
    ("AcousticMaterialRef", "alpha"): (0.0, 1e3),
    ("AcousticMaterialRef", "beta"): (0.0, 1e-2),
    ("SolveSettingsComponent", "num_vertices"): (1, 4096),
    ("SolveSettingsComponent", "solve_resolution"): (0.05, 1.0),
    ("SolveSettingsComponent", "num_modes"): (1, 512),
    ("SolveSettingsComponent", "min_mode_freq"): (1.0, 20_000.0),
    ("SolveSettingsComponent", "max_mode_freq"): (20.0, 24_000.0),
    ("ModalGainComponent", "value"): (0.0, 10.0),
    ("ModalTuningComponent", "fundamental_freq"): (0.0, 20_000.0),
    ("ModalTuningComponent", "t60_scale"): (0.01, 100.0),
    # Physics inspector limits (reference: PhysicsUi body/motion editors,
    # src/physics/PhysicsUi.cpp — mass/velocity fields clamped at the UI boundary).
    ("RigidBodyComponent", "mass"): (0.0, 1e5),
    ("RigidBodyComponent", "gravity_factor"): (-10.0, 10.0),
    ("RigidBodyComponent", "radius"): (1e-4, 1e3),
    ("RigidBodyComponent", "half_height"): (1e-4, 1e3),
    ("RigidBodyComponent", "plane_offset"): (-1e4, 1e4),
}


def clamp_field(component_type: str, field_name: str, value):
    lim = FIELD_LIMITS.get((component_type, field_name))
    if lim is None:
        return value
    return type(value)(np.clip(value, lim[0], lim[1]))


# ---- actions (one dataclass per intent; the union is the log's record type) ----


@dataclass
class AddObject:
    entity: Entity = 0  # 0 -> allocate; replay records the allocated id
    name: str = ""


@dataclass
class RemoveObject:
    entity: Entity = 0


@dataclass
class SetParent:
    entity: Entity = 0
    parent: Entity = 0


@dataclass
class SetTransform:
    entity: Entity = 0
    translation: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (1.0, 0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)


@dataclass
class SetField:
    """Generic clamped field patch on a registered component
    (reference: Update<Field>, src/action/Dispatch.h:20-62)."""

    entity: Entity = 0
    component: str = ""
    field_name: str = ""
    value: object = None


@dataclass
class SetAcousticMaterial:
    entity: Entity = 0
    name: str = "Ceramic"


@dataclass
class SetModalModel:
    """Bind a content-addressed solved model artifact (deterministic under replay)."""

    entity: Entity = 0
    path: str = ""


@dataclass
class StrikeVertex:
    entity: Entity = 0
    vertex: int = 0
    impulse: tuple = (0.0, 0.0, 0.0)
    contact_time: float = 1e-3


@dataclass
class AddPrimitive:
    """Create an object carrying a parametric primitive surface — the replayable
    form of the reference's object-add ops (src/object/, PrimitiveType.h:14-52).
    The mesh is derived from (kind, size, detail) at apply time, so replay rebuilds
    it deterministically without serializing vertex data into the log."""

    entity: Entity = 0
    name: str = ""
    kind: str = "icosphere"  # icosphere|cuboid|torus|uv_sphere|cylinder|cone|plane
    size: float = 1.0
    detail: int = 2


@dataclass
class SilenceObject:
    entity: Entity = 0


@dataclass
class SetFundamental:
    entity: Entity = 0
    freq: float = 0.0


@dataclass
class SetT60Scale:
    entity: Entity = 0
    scale: float = 1.0


@dataclass
class SetGain:
    entity: Entity = 0
    value: float = 1.0


Action = Union[
    AddObject, RemoveObject, SetParent, SetTransform, SetField, SetAcousticMaterial,
    SetModalModel, StrikeVertex, SilenceObject, SetFundamental, SetT60Scale, SetGain,
    AddPrimitive,
]

def _component_registry():
    # Field-patchable components = every Persistent component (the reference's
    # per-type registration, src/action/Dispatch.h:20-33); resolved lazily so late
    # registrations (armature, animation) are included.
    from .components import PERSISTENT_COMPONENTS

    return {c.__name__: c for c in PERSISTENT_COMPONENTS}


class _ComponentByName:
    def get(self, name):
        return _component_registry().get(name)

    def __iter__(self):
        return iter(_component_registry())


_COMPONENT_BY_NAME = _ComponentByName()

# Actions that write artifacts or are pure navigation are excluded from recording
# (reference: Recordable<T> opt-outs, src/action/Action.h:46-60). Strikes ARE recorded —
# they drive the audible timeline.
NON_RECORDABLE: tuple[type, ...] = ()


def apply_action(r: Registry, action: Action, synth_hooks=None) -> Entity | None:
    """The single mutation point (reference: action::ApplyEmitted/ApplyNow). Returns the
    entity an AddObject allocated. `synth_hooks` (optional) receives strike/silence
    intents — the bridge into the audio engine, kept out of the registry."""
    if isinstance(action, AddPrimitive):
        from ..mesh import (
            cone_surface, cuboid_surface, cylinder_surface, icosphere_surface,
            plane_surface, torus_surface, uv_sphere_surface,
        )

        sub = AddObject(entity=action.entity, name=action.name or action.kind)
        e = apply_action(r, sub, synth_hooks)
        action.entity = sub.entity
        s, d = float(action.size), int(action.detail)
        if action.kind == "cuboid":
            pts, tris = cuboid_surface((s, s, s))
        elif action.kind == "torus":
            pts, tris = torus_surface(s * 0.5, s * 0.2, 8 * d, 4 * d)
        elif action.kind == "uv_sphere":
            pts, tris = uv_sphere_surface(s * 0.5, 6 * d, 12 * d)
        elif action.kind == "cylinder":
            pts, tris = cylinder_surface(s * 0.5, s, 12 * d)
        elif action.kind == "cone":
            pts, tris = cone_surface(s * 0.5, s, 12 * d)
        elif action.kind == "plane":
            # plane_surface takes a (sx, sy) size; the reference passes (s, s) as size and
            # segments, so its "plane" primitive raises TypeError. The port passes the size.
            pts, tris = plane_surface((s, s))
        else:
            pts, tris = icosphere_surface(d)
            pts = pts * (s * 0.5)
        r.emplace(e, MeshSurface(positions=np.asarray(pts, np.float64),
                                 triangles=np.asarray(tris, np.uint32)))
        return e
    if isinstance(action, AddObject):
        e = action.entity or r.create()
        if action.entity and not r.valid(action.entity):
            # Replay path: recreate the recorded id.
            while r._next <= action.entity:
                r._alive[r._next] = False
                r._next += 1
            r._alive[e] = True
        r.emplace(e, Name(action.name))
        r.emplace(e, SceneNode())
        r.emplace(e, Transform())
        action.entity = e
        return e
    if isinstance(action, RemoveObject):
        r.destroy(action.entity)
        return None
    if not r.valid(action.entity):
        raise ActionError(f"action {type(action).__name__} on dead entity {action.entity}")
    if isinstance(action, SetParent):
        node = r.get(action.entity, SceneNode) or r.emplace(action.entity, SceneNode())
        node.parent = action.parent
        r.emplace(action.entity, node)
    elif isinstance(action, SetTransform):
        r.emplace(
            action.entity,
            Transform(
                np.asarray(action.translation, dtype=np.float64),
                np.asarray(action.rotation, dtype=np.float64),
                np.asarray(action.scale, dtype=np.float64),
            ),
        )
    elif isinstance(action, SetField):
        ctype = _COMPONENT_BY_NAME.get(action.component)
        if ctype is None:
            raise ActionError(f"unknown component {action.component}")
        comp = r.get(action.entity, ctype)
        if comp is None:
            comp = ctype()
        if action.field_name not in {f.name for f in fields(ctype)}:
            raise ActionError(f"{action.component} has no field {action.field_name}")
        setattr(comp, action.field_name,
                clamp_field(action.component, action.field_name, action.value))
        r.emplace(action.entity, comp)
    elif isinstance(action, SetAcousticMaterial):
        from ..materials import find_material

        m = find_material(action.name)
        if m is None:
            raise ActionError(f"unknown material {action.name}")
        p = m.properties
        r.emplace(action.entity, AcousticMaterialRef(
            m.name, p.density, p.young_modulus, p.poisson_ratio, p.alpha, p.beta))
    elif isinstance(action, SetModalModel):
        r.emplace(action.entity, ModalModel(action.path))
    elif isinstance(action, SetGain):
        r.emplace(action.entity, ModalGainComponent(
            clamp_field("ModalGainComponent", "value", action.value)))
    elif isinstance(action, SetFundamental):
        t = r.get(action.entity, ModalTuningComponent) or ModalTuningComponent()
        t.fundamental_freq = clamp_field("ModalTuningComponent", "fundamental_freq", action.freq)
        r.emplace(action.entity, t)
    elif isinstance(action, SetT60Scale):
        t = r.get(action.entity, ModalTuningComponent) or ModalTuningComponent()
        t.t60_scale = clamp_field("ModalTuningComponent", "t60_scale", action.scale)
        r.emplace(action.entity, t)
    elif isinstance(action, StrikeVertex):
        if synth_hooks is not None:
            synth_hooks.strike(action.entity, action.vertex,
                               np.asarray(action.impulse), action.contact_time)
    elif isinstance(action, SilenceObject):
        if synth_hooks is not None:
            synth_hooks.silence(action.entity)
    else:
        raise ActionError(f"unhandled action {type(action).__name__}")
    return None
