"""High-level API (counterpart of mesheditor_tpu/api.py): the solve-input pipeline and the
strike-render surface.

mesh in (obj/primitive + material) -> modal model -> rendered waveform:

    result = solve_surface(positions, tris, material.properties)   # or mesh2modes(tets, ..)
    synth  = make_synth([result])
    strike(synth, 0, 0, result, direction)
    wav    = synth.render_seconds(1.0)

Mirrors the reference's LaunchModalSolve pipeline (simplify -> tets -> solve -> postprocess,
src/audio/AudioSystem.cpp:1066-1152) and the strike dispatch (TriggerModalStrike,
:709-768), minus the interactive scene layer (see scene/).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import profile
from ._device import resolve_device
from .mesh.cdt import generate_tets_delaunay
from .mesh.halfedge import build_halfedge
from .mesh.simplify import simplify_surface
from .mesh.voxel_tets import generate_tets
from .solve.mesh2modes import ModalResult, SolveReuse, mesh2modes
from .synth.contact import (ContactDynamics, Striker, estimate_contact_time,
                            inverse_inertia_tensor, striker_impactor)
from .synth.engine import ModalSynth
from .types import AcousticMaterialProperties, ModalModes, ModalSolveSettings, SolverConfig


def solve_surface(
    positions: np.ndarray,
    tris: np.ndarray,
    material: AcousticMaterialProperties,
    excite_positions: Optional[np.ndarray] = None,
    settings: ModalSolveSettings = ModalSolveSettings(),
    baked_scale=(1.0, 1.0, 1.0),
    tet_resolution: int = 24,
    reuse: SolveReuse = SolveReuse(),
    cancelled=None,
    progress=None,
    verbose=None,
    device="cuda",
) -> ModalResult:
    """The full solve-input pipeline: simplify -> tetrahedralize -> FEM modal solve on
    `device`.

    Tetrahedralization prefers the native Delaunay mesher (surface vertices and skin
    preserved exactly; `settings.quality_tets` enables circumradius/edge <= 2 refinement,
    the reference's optional -q mode, Tetrahedralize.h:18-21). A surface it cannot mesh
    (its ValueError) goes to the voxel mesher; a mesher library that cannot be built or
    loaded raises instead, so the two are never mistaken for each other.
    `mesh.cdt.NATIVE_MESHES` and `mesh.voxel_tets.VOXEL_MESHES` count which one answered."""
    device = resolve_device(device)
    if settings.solve_resolution < 1.0:
        with profile.scope("solve/simplify"):
            positions, tris = simplify_surface(positions, tris, settings.solve_resolution)
    with profile.scope("solve/tetrahedralize"):
        tets = _tetrahedralize(positions, tris, tet_resolution, settings.quality_tets)
    if excite_positions is None:
        # Evenly spaced surface vertices, as the reference picks when none are assigned
        # (AudioSystem.cpp:953-957).
        idx = np.linspace(0, positions.shape[0] - 1, settings.num_vertices).astype(int)
        excite_positions = positions[idx]
    config = SolverConfig(
        min_mode_freq=settings.min_mode_freq,
        max_mode_freq=settings.max_mode_freq,
        num_modes=settings.num_modes,
        num_fem_modes=max(settings.num_modes + 15, settings.num_modes * 3 // 2),
    )
    return mesh2modes(
        tets, material, excite_positions, baked_scale, config, reuse, cancelled, progress,
        verbose=verbose, device=device,
    )


def _tetrahedralize(positions, tris, tet_resolution: int, quality_tets: bool):
    lo = np.asarray(positions, np.float64).min(axis=0)
    hi = np.asarray(positions, np.float64).max(axis=0)
    h = float((hi - lo).max()) / max(tet_resolution, 1)
    try:
        return generate_tets_delaunay(positions, tris, lattice_h=h,
                                      quality_bound=2.0 if quality_tets else 0.0)
    except ValueError:
        pass  # not meshable by the Delaunay mesher: the voxel mesher gets its try
    try:
        return generate_tets(positions, tris, resolution=tet_resolution)
    except ValueError as exc:
        # Diagnose the failure with topology before re-raising (the reference returns
        # tetrahedralization error strings, Tetrahedralize.h:44-60): open boundaries are
        # the usual cause of "no interior".
        nb = int(np.asarray(build_halfedge(positions, tris).boundary_halfedges()).size)
        if nb:
            raise ValueError(f"tetrahedralization failed: surface is not closed "
                             f"({nb} boundary half-edges); {exc}") from exc
        raise


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
