"""Reflection-driven field editing (reference: src/ui/FieldEdit.h — editors are
generated from component fields and emit `Update` actions clamped by FieldLimits).

Headless analog: `editable_fields` enumerates a component's editable fields with
their kinds and limits (dataclass introspection, the reflection the reference gets
from its registration macros), and `edit_field` routes a value change through the
action system's single mutation point with the same clamping (scene/actions.py
FIELD_LIMITS, reference src/action/Dispatch.h:63-106)."""

from __future__ import annotations

from dataclasses import fields, is_dataclass
from typing import Any

import numpy as np

from .actions import FIELD_LIMITS, SetField, apply_action
from .registry import Registry


def field_kind(value: Any) -> str:
    """Editor kind for a field value: bool | int | float | str | vec<N> | array."""
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, (int, np.integer)):
        return "int"
    if isinstance(value, (float, np.floating)):
        return "float"
    if isinstance(value, str):
        return "str"
    if isinstance(value, np.ndarray):
        if value.ndim == 1 and value.size in (2, 3, 4):
            return f"vec{value.size}"
        return "array"
    return "object"


def editable_fields(component) -> list[dict]:
    """Field descriptors for a component instance: name, kind, current value, and
    (lo, hi) limits when registered — what a generated editor row needs."""
    if not is_dataclass(component):
        return []
    ctype = type(component).__name__
    out = []
    for f in fields(component):
        value = getattr(component, f.name)
        kind = field_kind(value)
        if kind in ("array", "object"):
            continue  # bulk data is not field-editable (mesh buffers etc.)
        out.append({
            "name": f.name,
            "kind": kind,
            "value": value,
            "limits": FIELD_LIMITS.get((ctype, f.name)),
        })
    return out


def edit_field(r: Registry, entity: int, component_type: type, field_name: str,
               value, synth_hooks=None):
    """Apply one edited field through the action system (clamped, logged by the
    caller's action log exactly like any other action)."""
    action = SetField(entity=entity, component=component_type.__name__,
                      field_name=field_name, value=value)
    return apply_action(r, action, synth_hooks)


def describe_entity(r: Registry, entity: int) -> dict:
    """Inspector payload: every component on the entity with its editable fields
    (the reference's per-domain inspector windows, generated)."""
    out = {}
    for ctype in r.component_types():
        comp = r.get(entity, ctype)
        if comp is not None:
            rows = editable_fields(comp)
            if rows:
                out[ctype.__name__] = rows
    return out
