"""Animation clips: glTF-style keyframed channels over node TRS + morph weights.

Mirrors the reference's animation data model (src/animation/AnimationData.h:9-69):
channels target (entity, path) with Step / Linear / CubicSpline interpolation; a clip
evaluates at a time t and writes Transform components. Evaluation is vectorized numpy
(searchsorted keyframe lookup), the playback clock lives host-side.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from .components import Transform
from .registry import Registry


class Interpolation(Enum):
    STEP = "STEP"
    LINEAR = "LINEAR"
    CUBICSPLINE = "CUBICSPLINE"


class TargetPath(Enum):
    TRANSLATION = "translation"
    ROTATION = "rotation"
    SCALE = "scale"
    WEIGHTS = "weights"


@dataclass
class AnimationChannel:
    entity: int
    path: TargetPath
    times: np.ndarray  # (k,) seconds, ascending
    values: np.ndarray  # (k, d) — or (k, 3, d) for CUBICSPLINE (in-tangent, value, out-tangent)
    interpolation: Interpolation = Interpolation.LINEAR


@dataclass
class AnimationClip:
    name: str = ""
    channels: list[AnimationChannel] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return max((float(c.times[-1]) for c in self.channels if c.times.size), default=0.0)


def _sample_channel(c: AnimationChannel, t: float) -> np.ndarray:
    times = c.times
    if times.size == 0:
        raise ValueError("empty channel")
    t = float(np.clip(t, times[0], times[-1]))
    i = int(np.searchsorted(times, t, side="right") - 1)
    i = min(max(i, 0), times.size - 2) if times.size > 1 else 0
    if c.interpolation == Interpolation.STEP or times.size == 1:
        v = c.values[i]
        return v[1] if c.interpolation == Interpolation.CUBICSPLINE else v
    t0, t1 = float(times[i]), float(times[i + 1])
    dt = max(t1 - t0, 1e-12)
    u = (t - t0) / dt
    if c.interpolation == Interpolation.LINEAR:
        v0, v1 = c.values[i], c.values[i + 1]
        if c.path == TargetPath.ROTATION:
            # slerp (shortest arc) on wxyz quaternions.
            q0 = v0 / np.linalg.norm(v0)
            q1 = v1 / np.linalg.norm(v1)
            d = float(np.dot(q0, q1))
            if d < 0:
                q1, d = -q1, -d
            if d > 0.9995:
                q = q0 + u * (q1 - q0)
            else:
                th = np.arccos(np.clip(d, -1, 1))
                q = (np.sin((1 - u) * th) * q0 + np.sin(u * th) * q1) / np.sin(th)
            return q / np.linalg.norm(q)
        return (1 - u) * v0 + u * v1
    # CUBICSPLINE: values are (k, 3, d) = (in-tangent, value, out-tangent).
    p0 = c.values[i, 1]
    m0 = c.values[i, 2] * dt
    p1 = c.values[i + 1, 1]
    m1 = c.values[i + 1, 0] * dt
    u2, u3 = u * u, u * u * u
    v = (2 * u3 - 3 * u2 + 1) * p0 + (u3 - 2 * u2 + u) * m0 + (-2 * u3 + 3 * u2) * p1 + (u3 - u2) * m1
    if c.path == TargetPath.ROTATION:
        v = v / max(np.linalg.norm(v), 1e-30)
    return v


def evaluate_clip(r: Registry, clip: AnimationClip, t: float) -> dict[int, np.ndarray]:
    """Write sampled TRS into Transform components; returns sampled morph weights by
    entity (morph targets are carried by the caller's mesh layer)."""
    weights: dict[int, np.ndarray] = {}
    for c in clip.channels:
        if not r.valid(c.entity):
            continue
        v = _sample_channel(c, t)
        if c.path == TargetPath.WEIGHTS:
            weights[c.entity] = np.asarray(v)
            continue
        tr = r.get(c.entity, Transform) or Transform()
        if c.path == TargetPath.TRANSLATION:
            tr.translation = np.asarray(v, np.float64)
        elif c.path == TargetPath.ROTATION:
            tr.rotation = np.asarray(v, np.float64)
        elif c.path == TargetPath.SCALE:
            tr.scale = np.asarray(v, np.float64)
        r.emplace(c.entity, tr)
    return weights


@dataclass
class AnimationClipComponent:
    """An animation clip owned by a scene entity so clips persist, snapshot, and
    travel through glTF (the document's "animations" array; reference import at
    GltfScene.cpp animation handling)."""

    clip: AnimationClip = field(default_factory=AnimationClip)
