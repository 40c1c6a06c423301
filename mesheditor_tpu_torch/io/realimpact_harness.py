"""Recorded-vs-modal comparison over a RealImpact object scan.

The corpus-validation loop the reference runs against the RealImpact dataset
(reference: the RealImpact comparison path in src/audio/, loading deconvolved
recordings next to the solved modal model of the same scanned mesh): solve the
scan's mesh with its mapped material, strike each recorded impact vertex, and
score how well the modal model's ringing frequencies line up with the spectral
peaks of the recordings.

The score is deliberately simple and symmetric-free: for each prominent recorded
peak, the nearest rendered peak's error in cents; a model is "aligned" where the
median error is small and most recorded peaks find a rendered partner within half
a semitone. Absolute level is not compared (recordings are deconvolved per-mic).

Counterpart of mesheditor_tpu/io/realimpact_harness.py: the solve and the strike renders
run on the `device` the caller names ("cuda" by default), each strike through the impact
kernel there."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .realimpact import load_realimpact_scan, load_samples

SAMPLE_RATE = 48_000.0


def spectral_peaks(audio: np.ndarray, sample_rate: float = SAMPLE_RATE,
                   n_peaks: int = 12, fmin: float = 60.0,
                   fmax: float = 20_000.0) -> np.ndarray:
    """Prominent spectral peak frequencies (Hz), parabolic-interpolated, strongest
    first. Deterministic and windowed once over the whole clip — modal rings are
    stationary in frequency."""
    x = np.asarray(audio, np.float64)
    if x.size < 256:
        return np.zeros(0)
    spec = np.abs(np.fft.rfft(x * np.hanning(x.size)))
    freqs = np.fft.rfftfreq(x.size, 1.0 / sample_rate)
    lo = int(np.searchsorted(freqs, fmin))
    hi = int(np.searchsorted(freqs, fmax))
    peaks = []
    mag = spec.copy()
    mag[:lo] = 0.0
    # Cap at the solve band: peaks above max_mode_freq have no modal partner by
    # construction (the band filter drops them; postprocess.py), and the recordings'
    # noise floor otherwise reads back as spurious ultrasonic "partials".
    mag[hi:] = 0.0
    # 28 dB relative floor: a mode 30 dB under the strongest partial is inaudible next
    # to it, while the decay envelope's low-frequency hump sits below this and would
    # otherwise read back as spurious "recorded" partials.
    floor = mag.max() * 4e-2
    for _ in range(n_peaks):
        k = int(np.argmax(mag))
        if mag[k] <= floor or k <= 0 or k >= mag.size - 1:
            break
        # Parabolic interpolation on log magnitude.
        a, b, c = np.log(spec[k - 1] + 1e-300), np.log(spec[k] + 1e-300), \
            np.log(spec[k + 1] + 1e-300)
        denom = a - 2 * b + c
        delta = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
        peaks.append(float((k + np.clip(delta, -0.5, 0.5)) * sample_rate / x.size))
        # Null a neighborhood so the next pick is a different partial.
        w = max(3, x.size // 2048)
        mag[max(k - w, 0): k + w + 1] = 0.0
    return np.asarray(peaks)


def cents(f_test: float, f_ref: float) -> float:
    return abs(1200.0 * np.log2(max(f_test, 1e-9) / max(f_ref, 1e-9)))


@dataclass
class ImpactComparison:
    vertex: int
    recorded_peaks: np.ndarray
    rendered_peaks: np.ndarray
    matched_cents: np.ndarray  # per recorded peak: nearest rendered peak's error

    @property
    def median_cents(self) -> float:
        return float(np.median(self.matched_cents)) if self.matched_cents.size else np.inf

    @property
    def match_fraction(self) -> float:
        """Recorded peaks with a rendered partner within half a semitone."""
        if not self.matched_cents.size:
            return 0.0
        return float((self.matched_cents < 50.0).mean())


@dataclass
class ScanReport:
    object_name: str
    material_name: str | None
    impacts: list = field(default_factory=list)

    @property
    def median_cents(self) -> float:
        all_c = np.concatenate([i.matched_cents for i in self.impacts]) \
            if self.impacts else np.zeros(0)
        return float(np.median(all_c)) if all_c.size else np.inf

    @property
    def match_fraction(self) -> float:
        fr = [i.match_fraction for i in self.impacts]
        return float(np.mean(fr)) if fr else 0.0


def compare_impact(recorded: np.ndarray, rendered: np.ndarray, vertex: int,
                   sample_rate: float = SAMPLE_RATE, n_peaks: int = 10,
                   fmax: float = 20_000.0) -> ImpactComparison:
    rec = spectral_peaks(recorded, sample_rate, n_peaks, fmax=fmax)
    ren = spectral_peaks(rendered, sample_rate, n_peaks, fmax=fmax)
    matched = np.asarray([min((cents(r, q) for q in ren), default=np.inf) for r in rec])
    return ImpactComparison(vertex=vertex, recorded_peaks=rec, rendered_peaks=ren,
                            matched_cents=matched)


def compare_scan(directory, listener_point: int = 0, seconds: float = 0.5,
                 settings=None, tet_resolution: int = 24, material=None,
                 progress=None, device="cuda") -> ScanReport:
    """Solve the scan's mesh on `device` and compare every recorded impact against the
    modal render at the same vertex (impulse along the vertex normal estimate)."""
    from ..api import make_synth, solve_surface
    from ..materials import find_material
    from ..types import ModalSolveSettings

    scan = load_realimpact_scan(directory)
    if material is None:
        mat = find_material(scan.material_name or "Ceramic")
        material = (mat or find_material("Ceramic")).properties
    settings = settings or ModalSolveSettings(num_modes=30, num_vertices=10,
                                              max_mode_freq=20_000.0)
    result = solve_surface(
        scan.positions, scan.triangles, material,
        excite_positions=scan.impact_positions,
        settings=settings, tet_resolution=tet_resolution, progress=progress,
        device=device,
    )
    synth = make_synth([result], device=device)
    samples = load_samples(directory, listener_point)  # (5, frames)
    report = ScanReport(scan.object_name, scan.material_name)
    n = int(seconds * SAMPLE_RATE)
    expos_of = result.sample_point_of_excitation
    from ..synth.engine import ModalEvent

    for v in range(samples.shape[0]):
        expos = int(expos_of[v]) if v < expos_of.size else 0
        # A hard tap: ~0.25 ms contact (the RealImpact rig's solenoid striker on stiff
        # ceramic/metal is sub-millisecond) so the pulse spectrum stays broadband
        # through the whole solve band — a 3 ms contact lowpasses away every mode
        # above ~300 Hz and the comparison would only ever see the fundamental.
        # Off-axis j excites all shape components, not just the normal's.
        tau = 0.25e-3 * SAMPLE_RATE  # samples of contact
        synth.enqueue(ModalEvent(kind="impact", obj=0, expos=expos,
                                 j=(0.008, 0.02, 0.012), pulse_step=1.0 / tau,
                                 pulse_gamma=np.pi / 2 / tau, accel_amp=0.0))
        rendered = np.asarray(synth.render_seconds(seconds))
        synth.enqueue(ModalEvent(kind="silence", obj=0))
        synth.render(256)  # consume the silence
        fmax = float(getattr(settings, "max_mode_freq", 20_000.0))
        report.impacts.append(compare_impact(samples[v, :n], rendered[:n], v, fmax=fmax))
    return report
