"""The physics -> audio excitation bridge: contact reports become modal strikes and
sustained voices (counterpart of mesheditor_tpu/physics/bridge.py, on the port's engine).

The reference's audio contact handlers (AudioSystem.cpp:1311-1381): impact reports above
the impulse/speed floors trigger Hertz-timed strikes; persisting manifolds above the
slip/sweep floors publish sustained voices with Hunt-Crossley constants and content-keyed
roughness tracks for both sides. All host-side numpy; the synth takes it from there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..synth.contact import (
    ContactDynamics,
    Impactor,
    contact_patch_radius,
    contact_stiffness,
    estimate_contact_time,
    inv_effective_modulus,
    combined_curvature,
    static_penetration,
    RESTITUTION_REFERENCE_SPEED,
)
from ..synth.engine import ContactTrackSpec, ModalSynth, SustainedVoice
from ..synth.tracks import TRACK_SAMPLES, hash_params, synthesize_roughness
from ..types import AcousticMaterialProperties, ModalSoundControls
from .types import ContactImpact, SustainedContact


@dataclass
class ContactSurface:
    """Per-body acoustic finish (reference: src/audio/ContactSurface.h:19-34)."""

    roughness_sigma: float = 2e-6  # RMS height, m
    correlation_length: float = 2e-4  # m
    spectral_slope: float = -2.0
    spacing: float = 1e-6  # track sample spacing, m


# Presets (reference: ContactSurface.h:50-59).
SURFACE_POLISHED = ContactSurface(2e-7, 5e-5, -2.5)
SURFACE_MACHINED = ContactSurface(2e-6, 2e-4, -2.0)
SURFACE_SANDBLASTED = ContactSurface(8e-6, 1e-4, -1.6)
SURFACE_CAST = ContactSurface(2e-5, 5e-4, -1.8)


@dataclass
class AudioBody:
    """What the bridge knows about a sounding body."""

    synth_obj: int  # bank object slot
    dynamics: ContactDynamics
    material: AcousticMaterialProperties
    sample_positions: np.ndarray  # (p, 3) world-ish positions of the sample points
    surface: ContactSurface = field(default_factory=lambda: SURFACE_MACHINED)
    curvature: float = 0.0  # 1/m at typical contact sites


class AudioContactBridge:
    def __init__(self, synth: ModalSynth, controls: ModalSoundControls = ModalSoundControls()):
        self.synth = synth
        self.controls = controls
        self.bodies: dict[int, AudioBody] = {}  # physics handle -> audio body

    def register(self, handle: int, body: AudioBody) -> None:
        self.bodies[handle] = body

    def _nearest_sample_point(self, body: AudioBody, point: np.ndarray) -> int:
        d = ((body.sample_positions - point[None, :]) ** 2).sum(axis=1)
        return int(np.argmin(d))

    def _track_slot(self, surface: ContactSurface) -> int:
        key = hash_params(
            0x51F0, surface.correlation_length, surface.spectral_slope, surface.spacing
        )
        return self.synth.adopt_track(
            key,
            lambda: synthesize_roughness(
                surface.correlation_length, surface.spectral_slope, surface.spacing
            ),
        )

    def on_impacts(self, impacts: list[ContactImpact]) -> None:
        """Impact reports -> Hertz-timed modal strikes (thresholds keep settling and
        micro-jitter contacts from buzzing, reference: MinContactImpulse/Speed)."""
        c = self.controls
        for imp in impacts:
            if imp.impulse < c.min_contact_impulse or imp.speed < c.min_contact_speed:
                continue
            for handle, other in ((imp.body_a, imp.body_b), (imp.body_b, imp.body_a)):
                body = self.bodies.get(handle)
                if body is None:
                    continue
                other_body = self.bodies.get(other)
                other_mat = other_body.material if other_body else body.material
                impactor = Impactor(
                    material=other_mat,
                    curvature=other_body.curvature if other_body else 0.0,
                    inv_mass=imp.other_inv_mass,
                )
                expos = self._nearest_sample_point(body, imp.point)
                tau = estimate_contact_time(
                    body.dynamics, expos, imp.direction, imp.speed, body.material,
                    body.curvature, impactor,
                )
                self.synth.strike(
                    body.synth_obj, expos, imp.direction * imp.impulse, tau,
                    accel_amp=0.0,
                )

    def resolve_voices(self, sustained: dict[int, SustainedContact],
                       sample_rate: float = 48_000.0) -> list[SustainedVoice]:
        """Sustained manifolds -> the frame's whole voice set (publish with
        synth.publish_voices). Each sounding side of a contact gets its own voice
        (reference: BuildContactVoice x2 sides, AudioSystem.cpp:534-563)."""
        c = self.controls
        voices: list[SustainedVoice] = []
        for cid, sc in sustained.items():
            moving = (
                sc.slip_speed > c.min_slip_speed
                or sc.sweep_speed_a > c.min_sweep_speed
                or sc.sweep_speed_b > c.min_sweep_speed
            )
            if not moving or sc.normal_force <= 0:
                continue
            for side, (handle, other) in enumerate(
                ((sc.body_a, sc.body_b), (sc.body_b, sc.body_a))
            ):
                body = self.bodies.get(handle)
                if body is None:
                    continue
                other_body = self.bodies.get(other)
                other_mat = other_body.material if other_body else body.material
                inv_e = inv_effective_modulus(body.material, other_mat)
                kappa = combined_curvature(
                    body.curvature, other_body.curvature if other_body else 0.0
                )
                k = contact_stiffness(inv_e, kappa)
                delta0 = static_penetration(sc.normal_force, k)
                patch = contact_patch_radius(sc.normal_force, inv_e, kappa)
                # Hunt-Crossley dissipation from restitution at the reference speed:
                # e ~ 1 - alpha*v  =>  c_d = 1.5 * alpha (Hunt & Crossley 1975).
                alpha = max(1.0 - sc.restitution, 0.0) / RESTITUTION_REFERENCE_SPEED
                c_d = 1.5 * alpha * c.contact_damping
                normal = sc.normal if side == 0 else -sc.normal
                expos = self._nearest_sample_point(body, sc.point)
                # Slip direction in node-local terms: approximate with a horizontal unit
                # orthogonal to the normal (full frames arrive with mesh binding).
                t = np.cross(normal, [0.0, 1.0, 0.0])
                if np.linalg.norm(t) < 1e-6:
                    t = np.cross(normal, [1.0, 0.0, 0.0])
                t = t / max(np.linalg.norm(t), 1e-30)
                sweeps = (sc.sweep_speed_a, sc.sweep_speed_b)
                tracks = []
                for ti in range(4):
                    surf = (body.surface if ti % 2 == 0 else
                            (other_body.surface if other_body else body.surface))
                    sweep = sweeps[ti % 2]
                    if sweep <= c.min_sweep_speed:
                        tracks.append(ContactTrackSpec())
                        continue
                    slot = self._track_slot(surf)
                    step = sweep / sample_rate  # m per output sample
                    tracks.append(
                        ContactTrackSpec(
                            index=slot,
                            rate=step / surf.spacing,  # track samples per output sample
                            sigma=surf.roughness_sigma,
                            window=max(2 * patch / surf.spacing, 1.0),
                            step=step,
                        )
                    )
                voices.append(
                    SustainedVoice(
                        voice_id=(cid << 1) | side,
                        obj=body.synth_obj,
                        blend_points=(expos, expos, expos),
                        blend_weights=(1.0, 0.0, 0.0),
                        normal=tuple(normal),
                        slip_dir=tuple(t * (1.0 if sc.slip_speed > c.min_slip_speed else 0.0)),
                        sweep_dir=(tuple(t), tuple(-t)),
                        normal_force=float(sc.normal_force),
                        friction=float(sc.friction),
                        stiffness=float(k),
                        static_penetration=float(delta0),
                        damping_coeff=float(c_d),
                        tracks=tuple(tracks),
                    )
                )
        return voices[: self.controls.max_voices]
