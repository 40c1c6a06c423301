"""Derivation handlers: the per-frame systems tick (ProcessComponentEvents analog,
src/ProcessEvents.cpp:776). Order matters — it is the contract replay depends on."""

from __future__ import annotations

import numpy as np

from .components import SceneNode, Transform, WorldTransform
from .registry import Registry


def _trs_matrix(t: Transform) -> np.ndarray:
    w, x, y, z = t.rotation
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(t.scale)[None, :]
    m[:3, 3] = t.translation
    return m


def derive_world_transforms(r: Registry) -> None:
    """Compose local TRS down the parent chain (BuildMissingWorldTransforms +
    WorldTransform derivation analog). Deterministic order: ascending entity id with
    memoized parents."""
    world: dict[int, np.ndarray] = {}

    def resolve(e: int) -> np.ndarray:
        if e in world:
            return world[e]
        t = r.get(e, Transform)
        local = _trs_matrix(t) if t else np.eye(4)
        node = r.get(e, SceneNode)
        parent = node.parent if node else 0
        m = resolve(parent) @ local if parent and r.valid(parent) else local
        world[e] = m
        return m

    for e in sorted(r.entities()):
        if r.valid(e):
            r.emplace(e, WorldTransform(resolve(e)))


def install_default_pipeline(r: Registry) -> None:
    """Wire the standard derivation order (the InitEngine analog): transforms first,
    then skinning (the deform stage runs after pose state is settled)."""
    from .armature import derive_skinning

    r.on_process(derive_world_transforms)
    r.on_process(derive_skinning)
