"""The RealImpact loader and harness of the port (io/realimpact.py, io/realimpact_harness.py)
against the JAX package on the CPU, on a synthetic miniature dataset written under tmp_path
(the real 128 GB corpus is never read). Counterparts of tests/test_realimpact_loader.py:
the loader's answers equal the reference's on the same directory, and compare_scan on the
same miniature scan solves to the reference's frequencies within the port's solve
tolerances (tests/test_torch_pipeline.py) and scores its recordings the same."""

import numpy as np
import pytest
import torch

from mesheditor_tpu.io import realimpact as ref_ri
from mesheditor_tpu.io import realimpact_harness as ref_harness
from mesheditor_tpu import api as ref_api
from mesheditor_tpu import materials as ref_materials
from mesheditor_tpu import types as ref_types

from mesheditor_tpu_torch import api
from mesheditor_tpu_torch.io import RealImpactScan, load_listener_points, load_realimpact_scan
from mesheditor_tpu_torch.io import realimpact as ri
from mesheditor_tpu_torch.io import realimpact_harness as harness
from mesheditor_tpu_torch.materials import find_material
from mesheditor_tpu_torch.mesh import icosphere_surface, save_obj
from mesheditor_tpu_torch.synth import impact
from mesheditor_tpu_torch.types import ModalSolveSettings

HOST_PATH_RTOL = 5e-8  # tests/test_torch_pipeline.py: float64 frequencies, host path
SCALE3 = np.array([0.15, 0.12, 0.095])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fake_dataset(tmp_path):
    """tests/test_realimpact_loader.py's miniature object directory."""
    obj_dir = tmp_path / "9_BowlCeramic"
    pre = obj_dir / "preprocessed"
    pre.mkdir(parents=True)
    rng = np.random.default_rng(0)
    n = ri.NUM_LISTENER_POINTS
    np.save(pre / "angle.npy", np.repeat(np.arange(10) * 36, 60)[:n])
    np.save(pre / "distance.npy", np.tile(np.repeat([250, 500, 750, 1000], 15), 10)[:n])
    np.save(pre / "micID.npy", np.tile(np.arange(15), 40)[:n])
    np.save(pre / "listenerXYZ.npy", rng.uniform(-2000, 2000, (n, 3)))
    vxyz = np.repeat(rng.uniform(-100, 100, (ri.NUM_IMPACT_VERTICES, 3)), n, axis=0)
    np.save(pre / "vertexXYZ.npy", vxyz)
    np.save(pre / "deconvolved_0db.npy",
            rng.standard_normal((n * ri.NUM_IMPACT_VERTICES, 480)).astype(np.float32))
    pts, tris = icosphere_surface(1)
    save_obj(pre / "transformed.obj", pts * 100, tris)
    return obj_dir


def test_validate_and_material(fake_dataset):
    assert ri.validate_directory(fake_dataset) == "BowlCeramic"
    assert ri.material_for("BowlCeramic") == "Ceramic"
    assert ri.material_for("IronSkillet") == "Iron"
    assert ri.material_for("UnknownThing") is None
    assert ri.MATERIAL_FOR_OBJECT == ref_ri.MATERIAL_FOR_OBJECT


def test_listener_points(fake_dataset):
    pts = load_listener_points(fake_dataset)
    ref = ref_ri.load_listener_points(fake_dataset)
    assert len(pts) == ri.NUM_LISTENER_POINTS and pts[263].index == 263
    assert max(float(np.abs(p.position).max()) for p in pts) < 3.0  # mm -> m
    for a, b in zip(pts, ref):
        assert (a.index, a.mic_id, a.distance_mm, a.angle_deg) == \
            (b.index, b.mic_id, b.distance_mm, b.angle_deg)
        np.testing.assert_array_equal(a.position, b.position)


def test_samples_memory_mapped(fake_dataset):
    s = ri.load_samples(fake_dataset, listener_point_index=5)
    assert s.shape == (ri.NUM_IMPACT_VERTICES, 480) and s.dtype == np.float32
    np.testing.assert_array_equal(s, ref_ri.load_samples(fake_dataset, 5))


def test_full_scan(fake_dataset):
    scan = load_realimpact_scan(fake_dataset)
    ref = ref_ri.load_realimpact_scan(fake_dataset)
    assert type(scan) is RealImpactScan
    assert scan.object_name == "BowlCeramic" and scan.material_name == "Ceramic"
    assert scan.impact_positions.shape == (ri.NUM_IMPACT_VERTICES, 3)
    assert scan.positions.shape[1] == 3 and scan.triangles.shape[1] == 3
    for f in ("positions", "triangles", "impact_positions"):
        np.testing.assert_array_equal(getattr(scan, f), getattr(ref, f))


def test_z_up_rotation():
    q = ri.z_up_to_y_up(np.array([[1.0, 2.0, 3.0]]))
    assert np.allclose(q, [[-1.0, 3.0, 2.0]])  # (x, y, z) -> (-x, z, y)


def test_missing_dir_rejected(tmp_path):
    assert ri.validate_directory(tmp_path / "nope") is None
    with pytest.raises(FileNotFoundError):
        load_realimpact_scan(tmp_path / "nope")


def test_same_scene_same_bytes():
    """Two runs of the same scene in one process give byte-identical signals (the
    render-corpus discipline in the audio domain), on the port's CPU path."""
    from mesheditor_tpu_torch.synth import ModalEvent, ModalSynth
    from mesheditor_tpu_torch.types import ModalModes

    def run():
        m = ModalModes(freqs=np.linspace(100, 5000, 24), t60s=np.full(24, 0.2),
                       shapes=np.full((2, 24, 3), 0.01, np.float32))
        s = ModalSynth([m] * 3, gains=[1.0] * 3, max_impacts=8, max_voices=2, device="cpu")
        for o in range(3):
            s.enqueue(ModalEvent("impact", obj=o, j=(0.1, 0.05, 0), pulse_step=1 / 200,
                                 pulse_gamma=1.0, accel_amp=0.01))
        return torch.cat([s.render(512) for _ in range(6)]).numpy()

    a, b = run(), run()
    assert np.array_equal(a, b) and np.abs(a).max() > 0


def test_spectral_peaks_exact():
    sr = 48_000.0
    t = np.arange(24_000) / sr
    audio = (np.exp(-t * 6) * np.sin(2 * np.pi * 440.0 * t)
             + 0.5 * np.exp(-t * 9) * np.sin(2 * np.pi * 1234.5 * t))
    peaks = harness.spectral_peaks(audio, sr, n_peaks=4)
    np.testing.assert_array_equal(peaks, ref_harness.spectral_peaks(audio, sr, n_peaks=4))
    assert abs(min(peaks, key=lambda p: abs(p - 440.0)) - 440.0) < 1.0
    assert abs(min(peaks, key=lambda p: abs(p - 1234.5)) - 1234.5) < 1.0


def test_compare_scan_aligns_with_its_own_model(fake_dataset):
    """tests/test_realimpact_loader.py's harness loop through both packages: the scan's
    mesh re-authored at a solvable scale, "recordings" that ring at the port's solved
    frequencies, then compare_scan in each package. The port's solve agrees with the
    reference's within the host-path tolerance, the recorded peaks are the same numbers,
    the rendered peaks agree within one FFT bin, and the port's score meets the reference
    test's bounds."""
    pts, tris = icosphere_surface(1)
    pre = fake_dataset / "preprocessed"
    save_obj(pre / "transformed.obj", pts * SCALE3, tris)
    n, nv = ri.NUM_LISTENER_POINTS, ri.NUM_IMPACT_VERTICES
    np.save(pre / "vertexXYZ.npy", np.repeat(pts[:nv] * SCALE3, n, axis=0))
    scan = load_realimpact_scan(fake_dataset)
    kw = dict(num_modes=6, num_vertices=4, max_mode_freq=20_000.0)
    settings = ModalSolveSettings(**kw)
    result = api.solve_surface(scan.positions, scan.triangles, find_material("Ceramic").properties,
                               excite_positions=scan.impact_positions, settings=settings,
                               tet_resolution=6, device="cpu")
    ref = ref_api.solve_surface(scan.positions, scan.triangles,
                                ref_materials.find_material("Ceramic").properties,
                                excite_positions=scan.impact_positions,
                                settings=ref_types.ModalSolveSettings(**kw), tet_resolution=6)
    assert result.profile.dofs == ref.profile.dofs
    lam, rlam = result.summary.eigenvalues, np.asarray(ref.summary.eigenvalues)
    assert np.abs(np.sqrt(lam[6:] / rlam[6:]) - 1).max() < HOST_PATH_RTOL
    np.testing.assert_array_equal(result.sample_point_of_excitation,
                                  np.asarray(ref.sample_point_of_excitation))
    freqs = np.asarray(result.modes.freqs, np.float64)
    shapes = np.asarray(result.modes.shapes, np.float64)
    expos_of = np.asarray(result.sample_point_of_excitation, np.int64)
    rates = 6.9078 / np.maximum(np.asarray(result.modes.t60s, np.float64), 1e-3)
    t = np.arange(24_000) / 48_000.0
    rows = np.zeros((n * nv, t.size), np.float32)
    for v in range(nv):
        amp = np.abs(shapes[int(expos_of[min(v, expos_of.size - 1)]), :, 1])
        amp = np.where(amp > 0.1 * amp.max(), amp, 0.0)
        ring = sum(a * np.exp(-t * r) * np.sin(2 * np.pi * f * t)
                   for f, a, r in zip(freqs, amp, rates) if a > 0)
        rows[n * v] = ring.astype(np.float32)
    np.save(pre / "deconvolved_0db.npy", rows)

    before = impact.LAUNCHES
    report = harness.compare_scan(fake_dataset, seconds=0.5, settings=settings,
                                  tet_resolution=6, device="cpu")
    assert impact.LAUNCHES == before  # the CPU renders with the plain version
    ref_report = ref_harness.compare_scan(fake_dataset, seconds=0.5,
                                          settings=ref_types.ModalSolveSettings(**kw),
                                          tet_resolution=6)
    assert len(report.impacts) == nv
    assert report.median_cents < 30.0, report.median_cents
    assert report.match_fraction >= 0.5, report.match_fraction
    for imp, rimp in zip(report.impacts, ref_report.impacts):
        assert imp.matched_cents[0] < 5.0, imp.matched_cents
        np.testing.assert_array_equal(imp.recorded_peaks, rimp.recorded_peaks)
        # The strongest partials agree within 0.01 Hz; the picker's weaker picks are
        # side lobes of a strong partial, which the two renders' float orders may move by
        # one FFT bin (48 kHz / 24,000 samples = 2 Hz).
        assert imp.rendered_peaks.shape == rimp.rendered_peaks.shape
        assert abs(imp.rendered_peaks[0] - rimp.rendered_peaks[0]) < 0.01
        assert np.abs(imp.rendered_peaks - rimp.rendered_peaks).max() <= 2.0 + 1e-9
    assert report.match_fraction == ref_report.match_fraction
    assert report.median_cents == pytest.approx(ref_report.median_cents, abs=0.05)
