"""Top-level convenience API (counterpart of mesheditor_tpu/api.py): `make_synth`, the
contact dynamics of a solved model and the Hertz strike. Surface meshing
(`solve_surface`) comes with the solve-input slice."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .solve.mesh2modes import ModalResult
from .synth.contact import (ContactDynamics, Striker, estimate_contact_time,
                            inverse_inertia_tensor, striker_impactor)
from .synth.engine import ModalSynth
from .types import AcousticMaterialProperties, ModalModes


def make_synth(
    results: Sequence[ModalResult | ModalModes],
    gains: Optional[Sequence[float]] = None,
    sample_rate: float = 48_000.0,
    modal_level: float = 0.5,
    device="cuda",
    **kwargs,
) -> ModalSynth:
    """A synth over solved models on `device`. Per-object output gain defaults to the
    reference's mass-normalized scale: modal_level / mode_count (AudioSystem.cpp:576-579).
    Other keywords (max_impacts, max_voices, track_slots) go to ModalSynth."""
    modes_list = [r.modes if isinstance(r, ModalResult) else r for r in results]
    if gains is None:
        gains = [
            modal_level / max(m.num_modes, 1) * 1e3  # 1e3: mass-normalized shapes are tiny
            for m in modes_list
        ]
    return ModalSynth(modes_list, gains, sample_rate, device=device, **kwargs)


def contact_dynamics_for(result: ModalResult, scale_ratio: float = 1.0) -> ContactDynamics:
    """Per-object contact dynamics from solved mass properties + sample positions
    (reference: UpdateContactDynamics, src/audio/ContactDynamics.cpp:14-50)."""
    mp = result.mass_props
    positions = np.asarray(result.modes.positions, dtype=np.float64)
    arm = (positions - mp.center_of_mass) * scale_ratio
    return ContactDynamics(
        mass=mp.mass * scale_ratio**3,
        inverse_inertia=inverse_inertia_tensor(mp) / max(scale_ratio**5, 1e-30),
        contact_arm=arm,
    )


def strike(
    synth: ModalSynth,
    obj: int,
    expos: int,
    result: ModalResult,
    direction: np.ndarray,
    impulse_mag: float = 0.05,
    speed: float = 1.0,
    striker: Striker = Striker(),
    material: Optional[AcousticMaterialProperties] = None,
    object_curvature: float = 0.0,
    accel_amp: float = 0.0,
) -> float:
    """Hertz-modeled strike: derives the contact time from the virtual mallet and enqueues
    the impact (reference: TriggerModalStrike, AudioSystem.cpp:709-768). Returns tau."""
    dyn = contact_dynamics_for(result)
    imp = striker_impactor(striker)
    mat = material or AcousticMaterialProperties(2700, 7.2e10, 0.19)
    direction = np.asarray(direction, dtype=np.float64)
    direction = direction / max(np.linalg.norm(direction), 1e-30)
    tau = estimate_contact_time(dyn, expos, direction, speed, mat, object_curvature, imp)
    synth.strike(obj, expos, direction * impulse_mag, tau, accel_amp)
    return tau
