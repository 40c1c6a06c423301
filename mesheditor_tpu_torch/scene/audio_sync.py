"""Scene-reactive audio: reconcile ECS entities into a live modal synth.

The analog of the reference AudioSystem's entity loop (src/audio/AudioSystem.cpp:
OnCreate/OnModify of mesh, material, and solve-settings components mark the modal
model stale; `Process` re-solves what changed, rescales exactly what an E/rho edit
allows, and rebuilds the bank): every entity carrying MeshSurface +
AcousticMaterialRef is audible; `reconcile()` brings models and the ModalSynth bank
up to date with the registry, touching only what changed.

- Geometry / scale / Poisson / band edits -> re-solve (modal_model_stale).
- Density / Young / Rayleigh edits -> exact rescale, no eigensolve (RescaleModes,
  reference src/audio/mesh2modes.cpp:rescale path).
- Gain / tuning component edits -> bank coefficient retune only.
- Solved models persist content-addressed, with the solve fingerprint in the
  ModalModel component, so a reloaded scene re-solves nothing that still matches.

Counterpart of mesheditor_tpu/scene/audio_sync.py. The solves and the synth's bank live on
the `device` the caller names ("cuda" by default); everything else here is host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..profile import scope
from ..solve.orchestration import SolvedFingerprint, hash_solve_inputs, modal_model_stale
from ..types import (
    AcousticMaterialProperties, ModalModes, ModalSolveSettings, ModalTuning, SolverConfig,
)
from .components import (
    AcousticMaterialRef, ExciteState, MeshSurface, ModalGainComponent, ModalModel,
    ModalTuningComponent, SolveSettingsComponent, SoundVertices, Transform,
)
from .registry import Registry


@dataclass
class _EntityAudio:
    """Per-entity live state the registry does not hold (summaries are not components)."""

    modes: Optional[ModalModes] = None
    mass: object = None
    summary: object = None
    material: Optional[AcousticMaterialProperties] = None


@dataclass
class ReconcileReport:
    solved: list = field(default_factory=list)
    rescaled: list = field(default_factory=list)
    loaded: list = field(default_factory=list)
    removed: list = field(default_factory=list)
    up_to_date: list = field(default_factory=list)


class SceneAudio:
    """Keeps a ModalSynth consistent with a scene Registry."""

    def __init__(
        self,
        registry: Registry,
        store_dir,
        sample_rate: float = 48_000.0,
        tet_resolution: int = 24,
        modal_level: float = 0.5,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.registry = registry
        self.store_dir = store_dir
        self.sample_rate = float(sample_rate)
        self.tet_resolution = int(tet_resolution)
        self.modal_level = float(modal_level)
        self.synth = None
        self.samples = None  # SamplePlayer, lazily created by set_vertex_samples
        self._live: dict[int, _EntityAudio] = {}
        self._slots: dict[int, int] = {}

    # ---- scene scan ----

    def _audible(self):
        reg = self.registry
        out = []
        for e, surf in reg.view(MeshSurface):
            if surf.positions.shape[0] and reg.has(e, AcousticMaterialRef):
                out.append(e)
        return sorted(out)

    def _material(self, e) -> AcousticMaterialProperties:
        m = self.registry.get(e, AcousticMaterialRef)
        return AcousticMaterialProperties(
            m.density, m.young_modulus, m.poisson_ratio, m.alpha, m.beta
        )

    def _settings(self, e) -> SolveSettingsComponent:
        return self.registry.get(e, SolveSettingsComponent) or SolveSettingsComponent()

    def _scale(self, e) -> np.ndarray:
        t = self.registry.get(e, Transform)
        return np.asarray(t.scale, np.float64) if t is not None else np.ones(3)

    def _excite(self, e, surf) -> Optional[np.ndarray]:
        sv = self.registry.get(e, SoundVertices)
        if sv is not None and sv.vertices.size:
            return np.asarray(surf.positions, np.float64)[sv.vertices.astype(int)]
        return None

    def _fingerprint(self, e, surf) -> tuple[str, SolverConfig, AcousticMaterialProperties]:
        s = self._settings(e)
        mat = self._material(e)
        excite = self._excite(e, surf)
        inputs_hash = hash_solve_inputs(
            np.asarray(surf.positions, np.float64),
            np.asarray(surf.triangles, np.int64),
            np.zeros((0, 3)) if excite is None else excite,
            self._scale(e),
            s.quality_tets,
            s.solve_resolution,
        )
        config = SolverConfig(
            min_mode_freq=s.min_mode_freq, max_mode_freq=s.max_mode_freq,
            num_modes=s.num_modes,
        )
        return inputs_hash, config, mat

    # ---- reconcile ----

    def reconcile(self, progress=None) -> ReconcileReport:
        from ..api import solve_surface
        from ..io.model_store import load_modal_model, save_modal_model
        from ..solve.postprocess import rescale_modes

        reg = self.registry
        report = ReconcileReport()
        entities = self._audible()

        for gone in [e for e in self._live if e not in entities]:
            del self._live[gone]
            report.removed.append(gone)

        bank_dirty = bool(report.removed) or set(self._live) != set(entities)
        for e in entities:
            surf = reg.get(e, MeshSurface)
            inputs_hash, config, mat = self._fingerprint(e, surf)
            comp = reg.get(e, ModalModel)
            live = self._live.get(e)
            fp = SolvedFingerprint(
                comp.inputs_hash, comp.num_modes, comp.min_mode_freq,
                comp.max_mode_freq, comp.poisson_ratio,
            ) if comp is not None else SolvedFingerprint()

            need_solve = comp is None or modal_model_stale(fp, inputs_hash, config,
                                                           mat.poisson_ratio)
            if not need_solve:
                if live is None:
                    # Reloaded scene: the stored model still answers these inputs.
                    modes, mass = load_modal_model(comp.path)
                    live = self._live[e] = _EntityAudio(modes, mass, None, mat)
                    report.loaded.append(e)
                    bank_dirty = True
                elif live.material is not None and live.material != mat:
                    # Density/Young/Rayleigh edit: exact rescale when possible,
                    # re-solve only when the summary cannot (or was never kept).
                    rescaled = (
                        rescale_modes(live.summary, live.modes, mat, config)
                        if live.summary is not None else None
                    )
                    if rescaled is not None:
                        live.modes, live.material = rescaled, mat
                        comp.path = str(save_modal_model(self.store_dir, live.modes,
                                                         live.mass))
                        report.rescaled.append(e)
                        bank_dirty = True
                    else:
                        need_solve = True
                else:
                    report.up_to_date.append(e)

            if need_solve:
                s = self._settings(e)
                scale = self._scale(e)
                excite = self._excite(e, surf)
                result = solve_surface(
                    np.asarray(surf.positions, np.float64) * scale,
                    np.asarray(surf.triangles, np.int64),
                    mat,
                    excite_positions=None if excite is None else excite * scale,
                    settings=ModalSolveSettings(
                        num_vertices=s.num_vertices, solve_resolution=s.solve_resolution,
                        quality_tets=s.quality_tets, num_modes=s.num_modes,
                        min_mode_freq=s.min_mode_freq, max_mode_freq=s.max_mode_freq,
                    ),
                    baked_scale=scale,
                    tet_resolution=self.tet_resolution,
                    progress=progress,
                    device=self.device,
                )
                self._live[e] = _EntityAudio(result.modes, result.mass_props,
                                             result.summary, mat)
                path = save_modal_model(self.store_dir, result.modes, result.mass_props)
                reg.emplace(e, ModalModel(
                    path=str(path), inputs_hash=inputs_hash, num_modes=config.num_modes,
                    min_mode_freq=config.min_mode_freq, max_mode_freq=config.max_mode_freq,
                    poisson_ratio=mat.poisson_ratio,
                ))
                report.solved.append(e)
                bank_dirty = True

        if bank_dirty:
            self._rebuild_bank(entities)
        self._apply_tuning(entities)
        return report

    def _rebuild_bank(self, entities) -> None:
        from ..synth.engine import ModalSynth

        models = [self._live[e].modes for e in entities]
        gains = []
        for e, m in zip(entities, models):
            g = self.registry.get(e, ModalGainComponent)
            gains.append(
                self.modal_level / max(m.num_modes, 1) * 1e3 * (g.value if g else 1.0)
            )
        self.synth = (ModalSynth(models, gains, self.sample_rate, device=self.device)
                      if models else None)
        self._slots = {e: i for i, e in enumerate(entities)}
        for e in entities:
            self.registry.emplace(e, ExciteState(bank_slot=self._slots[e]))

    def _apply_tuning(self, entities) -> None:
        from ..synth.tuning import retuned_modes

        if self.synth is None:
            return
        for e in entities:
            t = self.registry.get(e, ModalTuningComponent)
            if t is None or (t.fundamental_freq == 0.0 and t.t60_scale == 1.0):
                continue
            modes = self._live[e].modes
            freqs, t60s = retuned_modes(
                modes, ModalTuning(t.fundamental_freq, t.t60_scale)
            )
            self.synth.retune(self._slots[e], freqs, t60s)

    # ---- playback ----

    def slot_of(self, e) -> int:
        return self._slots.get(e, -1)

    def strike(self, e, expos: int, j, pulse_step: float = 1.0 / 300.0,
               pulse_gamma: float = 20.0, accel_amp: float = 0.0) -> None:
        """Route a vertex strike by the entity's SoundVertices model: Samples-mode
        entities tap their registered recording (AudioSystem.cpp:1475-1489), everyone
        else excites the modal bank."""
        from ..synth.engine import ModalEvent
        from .components import SoundVertices

        sv = self.registry.get(e, SoundVertices)
        if sv is not None and sv.model == "samples" and self.samples is not None:
            # Recordings play at recorded level — they ARE the ground truth the modal
            # render is compared against; the strike only selects the vertex.
            if self.samples.trigger(self._slots.get(e, -1), expos):
                return  # recorded tap played; no modal excitation in Samples mode
        slot = self._slots.get(e)
        if slot is None or self.synth is None:
            return
        self.synth.enqueue(ModalEvent(
            kind="impact", obj=slot, expos=expos, j=tuple(np.asarray(j, np.float64)),
            pulse_step=pulse_step, pulse_gamma=pulse_gamma, accel_amp=accel_amp,
        ))

    def set_vertex_samples(self, e, clips) -> None:
        """Bind recorded clips to an entity's excite vertices (SetVertexSamples;
        RealImpact's ActivateRealImpactMicrophone lands here)."""
        from ..synth.samples import SamplePlayer

        if self.samples is None:
            self.samples = SamplePlayer(sample_rate=self.sample_rate)
        self.samples.set_vertex_samples(self._slots.get(e, -1), clips)

    def render_with_samples(self, num_samples: int) -> np.ndarray:
        """One block: modal render + recorded-sample playback mix (ProcessAudio's
        output sum, AudioSystem.cpp:1469-1491). The rendered block comes to the host once."""
        out = np.zeros(num_samples, np.float32)
        if self.synth is not None:
            out += self.synth.render(num_samples).cpu().numpy()
        if self.samples is not None:
            out += self.samples.mix(num_samples)
        return out


class SceneSimulation:
    """A physics scene that sounds, advanced one audio block at a time: the loop body of
    `simulate_scene` on its own, for callers that time or steer each block (an editor's
    play button, a benchmark's frame loop).

    The constructor solves what is stale (SceneAudio.reconcile), builds the physics world
    from the rigid-body components and registers every audible body with the contact
    bridge. `block()` runs the physics steps that fall in one block, bridges their contact
    reports into strikes and the block's voice set, and renders the block. `restart()`
    rebuilds the world and the bridge from the registry's current Transform and
    RigidBodyComponent values: the bank, its ringing state and its models stay, and nothing
    is solved.

    Spans (profile.py): each physics step is `play/physics`, the bridge's work
    (`on_impacts`, `resolve_voices`) `play/bridge`, both beside the engine's `play/block`
    render; the world counts `physics/steps` and `physics/contacts`."""

    def __init__(self, registry: Registry, store_dir, sample_rate: float = 48_000.0,
                 block_size: int = 512, gravity=(0.0, -9.81, 0.0), tet_resolution: int = 24,
                 progress=None, device="cuda"):
        self.registry = registry
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.gravity = gravity
        self.audio = SceneAudio(registry, store_dir, sample_rate, tet_resolution,
                                device=device)
        self.audio.reconcile(progress)
        self.restart()

    def restart(self) -> None:
        """A fresh world and bridge at the registry's current poses and velocities."""
        from ..physics.bridge import AudioBody, AudioContactBridge
        from ..physics.scene_build import build_world
        from ..synth.contact import ContactDynamics, inverse_inertia_tensor

        sa = self.audio
        self.world, self.handles = build_world(self.registry, gravity=self.gravity)
        self.bridge = AudioContactBridge(sa.synth) if sa.synth is not None else None
        if self.bridge is not None:
            for e, slot in sa._slots.items():
                if e not in self.handles:
                    continue
                live = sa._live[e]
                mp = live.mass
                positions = np.asarray(live.modes.positions, np.float64)
                dyn = ContactDynamics(
                    mass=float(getattr(mp, "mass", 0.0)),
                    inverse_inertia=inverse_inertia_tensor(mp),
                    contact_arm=positions - np.asarray(
                        getattr(mp, "center_of_mass", np.zeros(3))),
                )
                self.bridge.register(self.handles[e], AudioBody(
                    synth_obj=slot, dynamics=dyn, material=live.material,
                    sample_positions=positions,
                ))
        self.voices = []  # the voice set the last block published
        self._carry = 0.0

    def block(self, on_step=None):
        """One block: the physics steps the block's span of time holds (the fraction
        carries over), each step's impact reports struck, the voice set of the last step's
        sustained contacts published, and the block rendered. `on_step()` is called after
        each step. Returns the block as a device tensor, or None when nothing is audible."""
        world, bridge = self.world, self.bridge
        self._carry += self.block_size / self.sample_rate / world.dt
        steps = int(self._carry)
        self._carry -= steps
        for _ in range(steps):
            with scope("play/physics"):
                world.step()
            if bridge is not None and world.impacts:
                with scope("play/bridge"):
                    bridge.on_impacts(world.impacts)
            if on_step is not None:
                on_step()
        if bridge is None:
            return None
        with scope("play/bridge"):
            self.voices = bridge.resolve_voices(world.sustained, self.sample_rate)
        synth = self.audio.synth
        synth.publish_voices(self.voices)
        return synth.render(self.block_size)


def simulate_scene(
    registry: Registry,
    store_dir,
    seconds: float,
    sample_rate: float = 48_000.0,
    block_size: int = 512,
    gravity=(0.0, -9.81, 0.0),
    tet_resolution: int = 24,
    progress=None,
    on_frame=None,
    video_fps: float = 30.0,
    device="cuda",
) -> np.ndarray:
    """The reference's headline loop, scene-in/audio-out: entities carrying both a
    rigid body and an acoustic setup fall, collide, scrape — and sound. Solves what
    is stale (SceneAudio.reconcile), builds the physics world from the rigid-body
    components, bridges contact reports into strikes and sustained voices each audio
    block, and writes the simulated poses back onto the entities at the end
    (reference: AudioSystem::Process + PhysicsSystem step ordering). A loop over
    SceneSimulation.block.

    `on_frame(registry, frame_index)` fires at the `video_fps` frame clock with the
    current simulated poses written back and derived — render there for audio-locked
    video (the reference's --record capture of a playing scene).

    The rendered blocks stay on `device` until the end, so the host steps the physics of
    block n + 1 while the device still renders block n; one copy brings the audio back."""
    from ..physics.scene_build import write_back_poses

    sim = SceneSimulation(registry, store_dir, sample_rate, block_size, gravity,
                          tet_resolution, progress, device)
    total_blocks = int(np.ceil(seconds * sample_rate / block_size))
    clock = {"t": 0.0, "frame": 0}

    def frame_clock():
        clock["t"] += sim.world.dt
        if clock["t"] * video_fps >= clock["frame"]:
            write_back_poses(registry, sim.world, sim.handles)
            registry.process()
            on_frame(registry, clock["frame"])
            clock["frame"] += 1

    blocks = [sim.block(frame_clock if on_frame is not None else None)
              for _ in range(total_blocks)]
    write_back_poses(registry, sim.world, sim.handles)
    if sim.bridge is None or not blocks:
        return np.zeros(total_blocks * block_size, np.float32)
    return torch.cat(blocks).cpu().numpy()
