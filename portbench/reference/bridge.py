"""The reference's voice constants and surface tracks.

Frozen copies, in plain NumPy, of the closed forms the program's physics bridge uses for a
sustained contact (mesheditor_tpu_torch/physics/bridge.py `resolve_voices` and
synth/contact.py: Hertz stiffness k = (4/3) E* sqrt(R*), static penetration
(N/k)^(2/3), patch radius (3 N R* / (4 E*))^(1/3), Hunt-Crossley c_d = 1.5 (1 - e) / v_ref)
and of its roughness tracks (synth/tracks.py `synthesize_roughness`: a spectral
self-affine profile with SplitMix64 phases, normalised, with its running integral).
"""

from __future__ import annotations

import numpy as np

TRACK_SAMPLES = 32768
MIN_SLIP_SPEED = 0.005  # m/s, the program's ModalSoundControls defaults
MIN_SWEEP_SPEED = 0.005
CONTACT_DAMPING = 1.0
RESTITUTION_REFERENCE_SPEED = 1.0
MAX_VOICES = 16


def _splitmix64(state):
    with np.errstate(over="ignore"):
        state = state + np.uint64(0x9E3779B97F4A7C15)
        z = state
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return state, z


def hash_params(seed: int, *values: float) -> int:
    h = np.uint64(seed)
    with np.errstate(over="ignore"):
        for v in values:
            bits = np.frombuffer(np.float64(v).tobytes(), dtype=np.uint64)[0]
            h ^= bits + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6)) + (h >> np.uint64(2))
    return int(h)


def roughness(correlation_length, spectral_slope, spacing, count=TRACK_SAMPLES):
    """(heights (n,) float32, sums (n + 1,) float32): zero mean, unit RMS."""
    bins = count // 2 + 1
    q0 = 1.0 / max(correlation_length, 1e-9)
    q = np.arange(bins) * (1.0 / (count * spacing))
    with np.errstate(divide="ignore"):
        amp = np.where(q > q0, (q / np.where(q == 0, 1.0, q0)) ** (spectral_slope * 0.5), 1.0)
    amp[0] = 0.0
    state = np.uint64(hash_params(0x517CC1B727220A95, correlation_length, spectral_slope,
                                  spacing))
    with np.errstate(over="ignore"):
        states = state + np.uint64(0x9E3779B97F4A7C15) * np.arange(1, bins + 1, dtype=np.uint64)
    _, z = _splitmix64(states - np.uint64(0x9E3779B97F4A7C15))
    phases = (z >> np.uint64(40)).astype(np.float64) / float(1 << 24) * 2 * np.pi
    spectrum = amp * (np.cos(phases) + 1j * np.sin(phases))
    spectrum[0] = 0.0
    h = np.fft.irfft(spectrum, n=count)
    h = h - h.mean()
    rms = float(np.sqrt((h ** 2).mean()))
    h32 = (h / rms if rms > 0 else h).astype(np.float32)
    sums = np.zeros(count + 1, np.float32)
    np.cumsum(h32, out=sums[1:])
    return h32, sums


def voices(contacts, material: dict, surface_of, positions_of, sample_rate: float):
    """The voice set of `contacts` (dicts as inputs.contacts makes them), both sides of
    each, in the program's order. `surface_of(obj)` is (sigma, correlation, slope,
    spacing); `positions_of(obj)` the object's sample points. Each voice is a dict of its
    constants, with `tracks`, four (surface or None, rate, sigma, window, step)."""
    nu, e = material["poisson"], material["young"]
    inv_e = 2 * (1 - nu ** 2) / e  # the same material on both sides
    kappa = 1e-6  # flat sides: the combined curvature's floor
    out = []
    for c in contacts:
        moving = (c["slip_speed"] > MIN_SLIP_SPEED or c["sweep_speed_a"] > MIN_SWEEP_SPEED
                  or c["sweep_speed_b"] > MIN_SWEEP_SPEED)
        if not moving or c["normal_force"] <= 0:
            continue
        for side, (obj, other) in enumerate(((c["body_a"], c["body_b"]),
                                             (c["body_b"], c["body_a"]))):
            nf = c["normal_force"]
            k = 4.0 / 3.0 / inv_e / np.sqrt(kappa)
            delta0 = (max(nf, 0.0) / k) ** (2.0 / 3.0)
            patch = np.cbrt(0.75 * max(nf, 0.0) * inv_e / kappa)
            c_d = 1.5 * max(1.0 - c["restitution"], 0.0) / RESTITUTION_REFERENCE_SPEED
            c_d *= CONTACT_DAMPING
            normal = np.asarray(c["normal"], np.float64) * (1.0 if side == 0 else -1.0)
            pos = positions_of(obj)
            expos = int(np.argmin(((pos - np.asarray(c["point"])[None]) ** 2).sum(1)))
            t = np.cross(normal, [0.0, 1.0, 0.0])
            if np.linalg.norm(t) < 1e-6:
                t = np.cross(normal, [1.0, 0.0, 0.0])
            t = t / max(np.linalg.norm(t), 1e-30)
            sweeps = (c["sweep_speed_a"], c["sweep_speed_b"])
            tracks = []
            for ti in range(4):
                surf = surface_of(obj if ti % 2 == 0 else other)
                sweep = sweeps[ti % 2]
                if sweep <= MIN_SWEEP_SPEED:
                    tracks.append((None, 0.0, 0.0, 0.0, 0.0))
                    continue
                step = sweep / sample_rate
                tracks.append((tuple(surf), step / surf[3], surf[0],
                               max(2 * patch / surf[3], 1.0), step))
            out.append(dict(voice_id=(c["contact_id"] << 1) | side, obj=obj, expos=expos,
                            normal=normal, slip=t * (1.0 if c["slip_speed"] > MIN_SLIP_SPEED
                                                     else 0.0),
                            sweep=(t, -t), normal_force=float(nf), friction=float(c["friction"]),
                            stiffness=float(k), static_pen=float(delta0), damping=float(c_d),
                            tracks=tracks))
    return out[:MAX_VOICES]
