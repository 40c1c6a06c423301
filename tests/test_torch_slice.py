"""The port's main path as a whole — mesh2modes -> make_synth -> render_seconds — against
the JAX package on the same small box, and the bench's golden render bank.

The solve is compared as a modal model (frequencies, T60s, sign-aligned shapes of
well-separated modes). Audio is compared with both synths fed the SAME modal model: audio
rendered through two independent solves is not comparable sample by sample, because
degenerate modes rotate and signs flip (bench.py:141-147)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
from mesheditor_tpu import mesh2modes as jax_mesh2modes
from mesheditor_tpu.api import make_synth as jax_make_synth
from mesheditor_tpu.synth import ModalEvent as JaxModalEvent
from mesheditor_tpu.types import ModalModes as JaxModalModes

from mesheditor_tpu_torch import SolverConfig, convert, mesh2modes
from mesheditor_tpu_torch.api import make_synth
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import box_tets
from mesheditor_tpu_torch.solve import lobpcg
from mesheditor_tpu_torch.synth import ModalEvent
from mesheditor_tpu_torch.types import ModalModes

GOLDEN_BAND = (8.82e-3, 9.10e-3)  # bench.py:149


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def solves():
    mesh = box_tets((0.3, 0.16, 0.15), (4, 2, 2))
    excite = mesh.points[:: max(mesh.points.shape[0] // 5, 1)][:5]
    cfg = SolverConfig(tolerance=1e-8)
    before = lobpcg.DEVICE_SOLVES
    port = mesh2modes(mesh, CERAMIC.properties, excite, config=replace(cfg, small_n=0),
                      device="cpu")
    assert lobpcg.DEVICE_SOLVES == before + 1  # the device engine answered
    ref = jax_mesh2modes(mesh, CERAMIC.properties, excite, config=cfg)
    return port, ref


def strike_all(synth, n_obj, n_points, event_cls):
    for o in range(n_obj):
        synth.enqueue(event_cls(
            kind="impact", obj=o, expos=o % n_points, j=(0.05, 0.02, 0.01),
            pulse_step=1.0 / 150.0, pulse_gamma=np.pi / 2 / 150.0, accel_amp=0.001,
        ))


def test_modal_model_matches_reference(solves):
    port, ref = solves
    assert port.modes.num_modes == ref.modes.num_modes > 10
    assert np.abs(port.modes.freqs / ref.modes.freqs - 1).max() < 1e-6
    assert np.abs(port.modes.t60s / ref.modes.t60s - 1).max() < 1e-6
    assert port.modes.original_fundamental_freq == pytest.approx(
        ref.modes.original_fundamental_freq, rel=1e-6)
    np.testing.assert_array_equal(port.modes.positions, ref.modes.positions)


def test_shapes_match_reference_up_to_sign(solves):
    port, ref = solves
    f = ref.modes.freqs.astype(np.float64)
    gap = np.minimum(np.r_[np.inf, np.diff(f)], np.r_[np.diff(f), np.inf]) / f
    separated = np.flatnonzero(gap > 1e-4)
    assert separated.size >= 5
    a, b = port.modes.shapes, ref.modes.shapes  # (points, modes, 3)
    scale = np.abs(b).max()
    for k in separated:
        sa, sb = a[:, k].ravel(), b[:, k].ravel()
        sign = 1.0 if sa @ sb >= 0 else -1.0
        assert np.abs(sign * sa - sb).max() <= 1e-4 * scale, k


def test_render_matches_reference_on_the_same_modal_model(solves):
    _port, ref = solves
    m = ref.modes
    modes = convert.modal_modes(freqs=m.freqs, t60s=m.t60s, shapes=m.shapes,
                                positions=m.positions,
                                original_fundamental_freq=m.original_fundamental_freq)
    n_points = m.shapes.shape[0]
    synth = make_synth([modes] * 4, device="cpu")
    jsynth = jax_make_synth([m] * 4)
    strike_all(synth, 4, n_points, ModalEvent)
    strike_all(jsynth, 4, n_points, JaxModalEvent)
    a = synth.render_seconds(0.1, 512)
    b = np.asarray(jsynth.render_seconds(0.1, 512))
    assert a.shape == b.shape
    assert np.abs(a - b).max() < 2e-5 * np.abs(b).max()


def test_port_solve_renders(solves):
    port, _ref = solves
    synth = make_synth([port] * 4, device="cpu")
    strike_all(synth, 4, port.modes.shapes.shape[0], ModalEvent)
    audio = synth.render_seconds(0.1, 512)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0


def _golden(make, event_cls, modes_cls):
    rng = np.random.default_rng(20260820)
    k = 64
    modes = modes_cls(np.linspace(120.0, 9000.0, k), np.linspace(1.2, 0.15, k),
                      (rng.standard_normal((4, k, 3)) * 0.02).astype(np.float32))
    synth = make([modes] * 8)
    for o in range(8):
        synth.enqueue(event_cls(
            kind="impact", obj=o, expos=o % 4, j=(0.04, 0.03, 0.01),
            pulse_step=1.0 / 140.0, pulse_gamma=np.pi / 2 / 140.0, accel_amp=0.0005,
        ))
    return np.asarray(synth.render_seconds(1.0, 512), np.float64)


def test_golden_render():
    """bench.py's pinned golden render (bench.py:17-38,149) on the port, against the band
    and the reference's samples."""
    port = _golden(lambda ms: make_synth(ms, sample_rate=48_000.0, device="cpu"),
                   ModalEvent, ModalModes)
    ref = _golden(lambda ms: jax_make_synth(ms, sample_rate=48_000.0), JaxModalEvent,
                  JaxModalModes)
    rms = float(np.sqrt((port ** 2).mean()))
    assert GOLDEN_BAND[0] <= rms <= GOLDEN_BAND[1]
    assert np.abs(port - ref).max() < 2e-5 * np.abs(ref).max()
