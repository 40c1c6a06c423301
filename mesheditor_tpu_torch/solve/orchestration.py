"""Solve orchestration: input hashing, staleness, the warm-start memo, and fundamental
estimation — the glue the reference keeps in AudioSystem (src/audio/AudioSystem.cpp):

- `hash_solve_inputs` fingerprints the tet-solve inputs (:940-949); an unchanged hash
  with changed material/config routes to the warm path or the exact rescale.
- `ModalWarmStart` is the app-wide eigenbasis memo keyed by that hash
  (src/audio/ModalWarmStart.h:8-14): a material edit re-solves in a few iterations.
- `modal_model_stale` mirrors the staleness check (:1080-1090).
- `estimate_fundamental` picks the dominant low-frequency partial of a recorded sample
  via FFT with parabolic interpolation (:827-866), used to retune a solve so its
  fundamental matches a recording.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..types import SolverConfig


def hash_solve_inputs(
    positions: np.ndarray,
    triangles: np.ndarray,
    excite_positions: np.ndarray,
    baked_scale,
    quality_tets: bool = False,
    solve_resolution: float = 1.0,
) -> str:
    h = hashlib.sha256()
    for arr in (positions, triangles, excite_positions):
        a = np.ascontiguousarray(arr)
        h.update(a.tobytes())
        h.update(str(a.shape).encode())
    h.update(np.asarray(baked_scale, dtype=np.float64).tobytes())
    h.update(bytes([quality_tets]))
    h.update(np.float64(solve_resolution).tobytes())
    return h.hexdigest()[:32]


@dataclass
class SolvedFingerprint:
    """What a finished solve was asked for — the staleness comparison key."""

    inputs_hash: str = ""
    num_modes: int = 0
    min_mode_freq: float = 0.0
    max_mode_freq: float = 0.0
    poisson_ratio: float = 0.0


def modal_model_stale(current: SolvedFingerprint, inputs_hash: str, config: SolverConfig,
                      poisson_ratio: float) -> bool:
    """True when the live model no longer answers the requested solve
    (reference: ModalModelStale, AudioSystem.cpp:1080-1090). Density/Young edits are NOT
    staleness — they rescale exactly (RescaleModes); Poisson is."""
    return (
        current.inputs_hash != inputs_hash
        or current.num_modes != config.num_modes
        or current.min_mode_freq != config.min_mode_freq
        or current.max_mode_freq != config.max_mode_freq
        or current.poisson_ratio != poisson_ratio
    )


@dataclass
class ModalWarmStart:
    """App-wide warm-start slot: the last solve's eigenbasis keyed by tet-input hash.
    One slot suffices (the reference keeps one): edits iterate on one object at a time."""

    inputs_hash: str = ""
    basis: Optional[np.ndarray] = None  # (n_dofs, num_fem_modes) float32

    def offer(self, inputs_hash: str, basis: Optional[np.ndarray]) -> None:
        if basis is not None and basis.size:
            self.inputs_hash = inputs_hash
            self.basis = basis

    def lookup(self, inputs_hash: str) -> Optional[np.ndarray]:
        return self.basis if (self.basis is not None and self.inputs_hash == inputs_hash) else None


def estimate_fundamental(
    samples: np.ndarray,
    sample_rate: float = 48_000.0,
    min_freq: float = 20.0,
    max_freq: float = 8_000.0,
) -> float:
    """Dominant partial of a recording in [min_freq, max_freq], Hz, with parabolic bin
    interpolation (reference: FindFundamentalFreq, AudioSystem.cpp:827-866). Returns 0
    when nothing rises above the floor."""
    x = np.asarray(samples, dtype=np.float64).reshape(-1)
    if x.size < 256:
        return 0.0
    x = x - x.mean()
    w = np.hanning(x.size)
    spec = np.abs(np.fft.rfft(x * w))
    freqs = np.fft.rfftfreq(x.size, 1.0 / sample_rate)
    band = (freqs >= min_freq) & (freqs <= max_freq)
    if not band.any():
        return 0.0
    idx = np.flatnonzero(band)
    k = idx[np.argmax(spec[idx])]
    if spec[k] <= 1e-12:
        return 0.0
    # Parabolic interpolation over the log spectrum.
    if 0 < k < spec.size - 1:
        a, b, c = np.log(np.maximum(spec[k - 1 : k + 2], 1e-30))
        denom = a - 2 * b + c
        delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
        delta = float(np.clip(delta, -0.5, 0.5))
    else:
        delta = 0.0
    return float((k + delta) * sample_rate / x.size)
