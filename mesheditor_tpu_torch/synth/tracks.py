"""Surface roughness tracks: self-affine height profiles a sustained contact rides over.

A track is a cyclic height sequence indexed by distance along the surface. Synthesis is
spectral: flat below the spatial frequency q0 = 1/correlation_length, falling as q^(slope/2)
in amplitude above it, with deterministic SplitMix64-derived phases and an inverse real FFT
(reference: src/audio/SurfaceNoise.cpp:38-70, rebuilt with np.fft.irfft). Heights are
normalized to zero mean / unit RMS, and a running integral makes an O(1) box-filtered read —
the contact filter (reference: SurfaceNoise.h:54-65).

Determinism discipline: phases derive from a hash of the surface parameters alone, so only
the parameters persist and replay reproduces identical tracks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# At micron-scale spacing a contact crosses ~0.2 m of surface before the cycle repeats.
TRACK_SAMPLES = 32768


def _splitmix64(state: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized SplitMix64 step: returns (new_state, output). uint64 wrap-around."""
    with np.errstate(over="ignore"):
        state = state + np.uint64(0x9E3779B97F4A7C15)
        z = state
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return state, z


def hash_params(seed: int, *values: float) -> int:
    """Deterministic content key over float parameters (bit-pattern based, so it is stable
    across platforms — unlike std::hash). Mirrors the role of the reference's HashParams."""
    h = np.uint64(seed)
    with np.errstate(over="ignore"):
        for v in values:
            bits = np.frombuffer(np.float64(v).tobytes(), dtype=np.uint64)[0]
            h ^= bits + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6)) + (h >> np.uint64(2))
    return int(h)


@dataclass
class RoughnessTrack:
    heights: np.ndarray  # (n,) float32, zero-mean, unit RMS
    sums: np.ndarray  # (n+1,) float32 running integral, so a smoothed read is two lookups
    spacing: float  # distance between samples along the surface, m
    rms: float = 1.0  # RMS height of the source, m (profile tracks); synthesized leave 1


def _finish(heights: np.ndarray, spacing: float) -> RoughnessTrack:
    heights = np.asarray(heights, dtype=np.float64)
    n = heights.shape[0]
    heights = heights - heights.mean() if n else heights
    rms = float(np.sqrt((heights**2).mean())) if n else 0.0
    if rms > 0:
        heights = heights / rms
    h32 = heights.astype(np.float32)
    sums = np.zeros(n + 1, dtype=np.float32)
    np.cumsum(h32, out=sums[1:])
    return RoughnessTrack(h32, sums, spacing, rms)


def synthesize_roughness(
    correlation_length: float, spectral_slope: float, spacing: float, count: int = TRACK_SAMPLES
) -> RoughnessTrack:
    """Deterministic in its arguments, so only the surface parameters persist."""
    if count < 2 or spacing <= 0:
        return _finish(np.zeros(max(count, 0)), spacing)
    bins = count // 2 + 1
    q0 = 1.0 / max(correlation_length, 1e-9)
    dq = 1.0 / (count * spacing)
    q = np.arange(bins) * dq
    with np.errstate(divide="ignore"):
        amplitude = np.where(q > q0, (q / np.where(q == 0, 1.0, q0)) ** (spectral_slope * 0.5), 1.0)
    amplitude[0] = 0.0  # zero mean

    state = np.uint64(hash_params(0x517CC1B727220A95, correlation_length, spectral_slope, spacing))
    # SplitMix64 states advance by a fixed constant per draw, so the sequence vectorizes.
    with np.errstate(over="ignore"):
        states = state + np.uint64(0x9E3779B97F4A7C15) * np.arange(1, bins + 1, dtype=np.uint64)
    _, z = _splitmix64(states - np.uint64(0x9E3779B97F4A7C15))
    phases = (z >> np.uint64(40)).astype(np.float64) / float(1 << 24) * 2 * np.pi

    spectrum = amplitude * (np.cos(phases) + 1j * np.sin(phases))
    spectrum[0] = 0.0
    # Match the conventional unnormalized c2r transform (the irfft here scales by 1/n; the
    # subsequent unit-RMS normalization makes the two conventions identical).
    heights = np.fft.irfft(spectrum, n=count)
    return _finish(heights, spacing)


def make_profile_track(heights: np.ndarray, spacing: float) -> RoughnessTrack:
    """A track from measured profile heights; `rms` keeps the source's physical scale."""
    return _finish(np.asarray(heights, dtype=np.float64), spacing)


def wrap_track_pos(n: int, pos: float):
    wraps = np.floor(pos / n)
    f = max(pos - wraps * n, 0.0)
    i = min(int(f), n - 1)
    return i, f - i, wraps


def track_integral(track: RoughnessTrack, pos: float) -> float:
    i, frac, wraps = wrap_track_pos(track.heights.shape[0], pos)
    return float(track.sums[i] + frac * track.heights[i] + wraps * track.sums[-1])


def read_track(track: RoughnessTrack, pos: float, window: float) -> float:
    """Mean height over `window` samples centered on `pos` — the contact filter. A window
    of <= 1 sample degenerates to linear interpolation."""
    n = track.heights.shape[0]
    if window <= 1.0:
        i, frac, _ = wrap_track_pos(n, pos)
        j = i + 1 if i + 1 < n else 0
        return float(track.heights[i] + frac * (track.heights[j] - track.heights[i]))
    half = 0.5 * window
    return (track_integral(track, pos + half) - track_integral(track, pos - half)) / window
