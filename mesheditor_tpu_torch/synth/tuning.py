"""Retuning laws: how a live modal model retunes under scale, fundamental, and T60 edits
without re-solving.

Mirrors the reference's in-place retune paths (AudioSystem.cpp:593-623, 576-579):
- uniform scale s relative to the baked scale shifts every frequency by 1/s (a scaled
  object is a scaled instrument), and T60s follow the damping model at the new frequency;
- a fundamental-frequency override shifts all modes proportionally;
- a T60 scale multiplies every decay time;
- the mass-normalized output gain follows scale^-1.5 / mode_count (shape amplitudes are
  kg^-1/2; mass ~ s^3).
"""

from __future__ import annotations

import numpy as np

from ..types import ModalModes, ModalTuning


def retuned_modes(
    modes: ModalModes,
    tuning: ModalTuning = ModalTuning(),
    uniform_scale: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(freqs, t60s) after applying the tuning + a uniform scale relative to baked."""
    freqs = np.asarray(modes.freqs, np.float64).copy()
    t60s = np.asarray(modes.t60s, np.float64).copy()
    if freqs.size == 0:
        return freqs.astype(np.float32), t60s.astype(np.float32)
    scale_ratio = uniform_scale / float(np.mean(modes.baked_scale))
    if scale_ratio > 0 and scale_ratio != 1.0:
        freqs = freqs / scale_ratio
    if tuning.fundamental_freq > 0 and freqs[0] > 0:
        freqs = freqs * (tuning.fundamental_freq / freqs[0])
    t60s = t60s * max(tuning.t60_scale, 1e-6)
    return freqs.astype(np.float32), t60s.astype(np.float32)


def mass_normalized_gain(modal_level: float, mode_count: int, scale_ratio: float = 1.0) -> float:
    """Output gain: modal_level * scale^-1.5 / mode_count (reference: AudioSystem.cpp:576-579).
    Mass-normalized shapes scale as 1/sqrt(mass) ~ s^-1.5 under uniform scaling."""
    return float(modal_level * max(scale_ratio, 1e-9) ** -1.5 / max(mode_count, 1))
