"""Timeline: the frame clock uniting animation clips and baked physics playback
(reference: timeline UI + `physics::AdvancePlayback`/`BakeThrough`/`SamplePosesAtFrame`,
src/physics/PhysicsSystem.h:22-30, and the frame pipeline's playback tick,
src/ProcessEvents.cpp:1615).

Deterministic by construction: physics poses are baked once at a fixed substep rate and
sampled per frame (the reference's BodyPoseCache), and animation clips evaluate at the
exact frame time — replaying the same timeline yields byte-identical Transforms.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .animation import AnimationClip, evaluate_clip
from .components import MeshSurface, Transform
from .registry import Registry


@dataclass
class TimelineComponent:
    """Persistent playback state (one per scene entity that owns the timeline)."""

    frame: int = 0
    fps: float = 30.0
    start_frame: int = 0
    end_frame: int = 120
    playing: bool = False
    loop: bool = True


class Timeline:
    """Binds a registry, its animation clips, and a baked physics world to one clock.

    Usage:
        tl = Timeline(r, clips=[clip], fps=30)
        tl.bake_physics(seconds=4.0)        # optional: deterministic pose cache
        tl.seek(frame)                      # evaluate everything at that frame
        tl.tick()                           # advance one frame when playing
    """

    def __init__(self, registry: Registry, clips: list[AnimationClip] | None = None,
                 fps: float = 30.0, substeps_per_frame: int | None = None):
        self.r = registry
        if clips is None:
            # Default to the scene's own clips (AnimationClipComponent — e.g. from a
            # glTF import).
            from .animation import AnimationClipComponent

            clips = [c.clip for _, c in sorted(registry.view(AnimationClipComponent))]
        self.clips = list(clips)
        self.fps = float(fps)
        self.state = TimelineComponent(fps=self.fps)
        self._world = None
        self._handles: dict[int, int] = {}
        self._physics_dt = 1.0 / 240.0
        self._substeps = substeps_per_frame or max(
            int(round(1.0 / (self.fps * self._physics_dt))), 1
        )
        self._baked_frames = 0

    # -- physics baking (BakeThrough / SamplePosesAtFrame) --

    def bake_physics(self, seconds: float, gravity=(0.0, -9.81, 0.0)) -> int:
        """Build the world from the scene's rigid-body components and bake poses for
        `seconds` of playback. Returns the number of baked frames."""
        from ..physics.scene_build import build_world

        self.r.process()
        self._world, self._handles = build_world(self.r, gravity=gravity,
                                                 dt=self._physics_dt)
        frames = max(int(round(seconds * self.fps)), 1)
        self._world.bake_through(frames * self._substeps)
        self._baked_frames = frames
        self.state.end_frame = max(self.state.end_frame, frames - 1)
        return frames

    def _apply_baked(self, frame: int) -> None:
        if self._world is None:
            return
        step = min(frame, self._baked_frames - 1) * self._substeps
        poses = self._world.sample_poses_at(step)
        if poses is None:
            return
        for e, h in self._handles.items():
            pos, quat = poses[h]
            t = self.r.get(e, Transform) or Transform()
            t.translation = pos.copy()
            t.rotation = quat.copy()
            self.r.emplace(e, t)

    # -- the clock --

    def seek(self, frame: int) -> None:
        """Evaluate animation + baked physics at an absolute frame and re-derive."""
        self.state.frame = int(frame)
        t = frame / self.fps
        for clip in self.clips:
            weights = evaluate_clip(self.r, clip, t)
            for e, w in weights.items():
                surf = self.r.get(e, MeshSurface)
                if surf is not None:
                    surf.morph_weights = np.asarray(w, np.float64)
        self._apply_baked(self.state.frame)
        self.r.process()

    def tick(self) -> bool:
        """Advance one frame when playing (the per-frame playback tick). Returns
        whether the frame changed."""
        if not self.state.playing:
            return False
        nxt = self.state.frame + 1
        if nxt > self.state.end_frame:
            if not self.state.loop:
                self.state.playing = False
                return False
            nxt = self.state.start_frame
        self.seek(nxt)
        return True

    def play(self) -> None:
        self.state.playing = True

    def pause(self) -> None:
        self.state.playing = False

    def frames(self):
        """Iterate start..end deterministically, seeking each (the headless
        fixed-step capture loop, README.md:182)."""
        for f in range(self.state.start_frame, self.state.end_frame + 1):
            self.seek(f)
            yield f
