"""Mode postprocessing: eigenvalues -> damped frequencies, T60s, band filtering, optional
fundamental rescaling; and the exact material-edit rescale fast path.

Semantics mirror the reference (modal::PostprocessModes, src/audio/mesh2modes.cpp:515-588;
modal::RescaleModes, :590-603): Rayleigh damping c = alpha + beta*omega^2, damped frequency
omega_d = sqrt(omega^2 - c^2/4), T60 = 2*ln(1000)/c, audible-band filter against
[min_mode_freq, max_mode_freq], fundamental-frequency scaling applied to undamped omegas.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..types import AcousticMaterialProperties, ModalModes, SolverConfig


@dataclass
class ModalEigenSummary:
    """Raw eigenpairs at the excitation positions + the solved material, enough to re-derive
    the modal model exactly under an E/rho edit (reference: src/audio/ModalEigenSummary.h)."""

    eigenvalues: np.ndarray = field(default_factory=lambda: np.zeros(0))
    shapes: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 3), np.float32))
    solved_material: Optional[AcousticMaterialProperties] = None
    tet_inputs_hash: int = 0

    def __post_init__(self):
        # Near-rigid eigenvalues come back as tiny NEGATIVE values from any solver
        # backend (the pencil is PSD; roundoff puts true zeros at ~-eps*||K x||).
        # Clamp HERE — the one construction point every engine path flows through —
        # so sqrt(eigenvalues) is warning-free for every consumer (postprocess,
        # rescale, callers doing their own frequency math). Reference contract:
        # PostprocessModes treats them as zero (src/audio/mesh2modes.cpp:515-588).
        ev = np.asarray(self.eigenvalues, np.float64)
        if ev.size:
            self.eigenvalues = np.maximum(ev, 0.0)


def postprocess_modes(
    eigenvalues: np.ndarray,
    shapes: np.ndarray,
    shape_scale: float,
    material: AcousticMaterialProperties,
    config: SolverConfig,
    positions: np.ndarray,
) -> ModalModes:
    """`shapes` is (num_sample_points, num_fem_modes, 3); returns the audible-band model."""
    eigenvalues = np.asarray(eigenvalues, dtype=np.float64).reshape(-1)
    fem_n = eigenvalues.shape[0]
    if fem_n == 0:
        return ModalModes(np.zeros(0), np.zeros(0), np.zeros((0, 0, 3), np.float32))

    # Scale-aware near-zero cutoff, relative to the eigensolver shift: rigid-body modes
    # carry numerically tiny but nonzero eigenvalues.
    lambda_eps = (2 * np.pi * config.min_mode_freq) ** 2 * 1e-10
    omega_undamped = np.where(eigenvalues > lambda_eps, np.sqrt(np.maximum(eigenvalues, 0)), 0.0)

    def c_from_omega(omega):
        return material.alpha + material.beta * omega**2

    def damped_hz(omega, c):
        omega_d_sq = omega**2 - 0.25 * c**2
        return np.where(omega_d_sq > 0, np.sqrt(np.maximum(omega_d_sq, 0)) / (2 * np.pi), 0.0)

    freqs = np.where(omega_undamped > 0, damped_hz(omega_undamped, c_from_omega(omega_undamped)), 0.0)

    # The lowest valid mode is the first at or above the audible floor.
    valid = (omega_undamped > 0) & (freqs >= config.min_mode_freq)
    if not valid.any():
        return ModalModes(np.zeros(0), np.zeros(0), np.zeros((0, 0, 3), np.float32))
    lowest = int(np.argmax(valid))
    lowest_freq_orig = float(freqs[lowest])

    # Scale all modes so the lowest valid one sits at the configured fundamental, and derive
    # T60s from the scaled frequencies.
    freq_scale = (config.fundamental_freq / lowest_freq_orig) if config.fundamental_freq else 1.0
    omega_s = omega_undamped[lowest:] * freq_scale
    c = c_from_omega(omega_s)
    out_freqs = damped_hz(omega_s, c)
    out_t60s = np.where(c > 0, 2 * np.log(1000.0) / np.where(c == 0, 1.0, c), 0.0)

    # Keep modes that are only above the max frequency because of scaling, so changing the
    # fundamental does not lose the higher modes.
    max_freq = config.max_mode_freq * max(1.0, freq_scale)
    highest = out_freqs.shape[0]
    while highest > 0 and out_freqs[highest - 1] > max_freq:
        highest -= 1

    n_modes = min(config.num_modes, fem_n, highest)
    out_freqs = out_freqs[:n_modes].astype(np.float32)
    out_t60s = out_t60s[:n_modes].astype(np.float32)

    shapes = np.asarray(shapes, dtype=np.float32)
    out_shapes = shapes[:, lowest : lowest + n_modes, :] * np.float32(shape_scale)

    return ModalModes(
        freqs=out_freqs,
        t60s=out_t60s,
        shapes=out_shapes,
        positions=np.asarray(positions, dtype=np.float32).reshape(-1, 3),
        original_fundamental_freq=lowest_freq_orig,
    )


def rescale_modes(
    summary: ModalEigenSummary,
    current: ModalModes,
    material: AcousticMaterialProperties,
    config: SolverConfig = SolverConfig(),
) -> Optional[ModalModes]:
    """Exact re-derivation of the modal model under a material edit at unchanged tet inputs:
    E and rho scale the FEM matrices linearly, so eigenvalues scale by (E'/E)/(rho'/rho) and
    mass-normalized shapes by 1/sqrt(rho'/rho). None when the edit is not exactly scalable
    (Poisson ratio differs)."""
    if summary.eigenvalues.size == 0 or summary.solved_material is None:
        return None
    if material.poisson_ratio != summary.solved_material.poisson_ratio:
        return None
    rho_ratio = material.density / summary.solved_material.density
    eig_scale = (material.young_modulus / summary.solved_material.young_modulus) / rho_ratio
    modes = postprocess_modes(
        summary.eigenvalues * eig_scale,
        summary.shapes,
        float(1.0 / np.sqrt(rho_ratio)),
        material,
        config,
        current.positions,
    )
    modes.vertices = current.vertices
    modes.indices = current.indices
    modes.baked_scale = current.baked_scale
    return modes
