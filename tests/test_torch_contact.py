"""Port contact models (mesheditor_tpu_torch/synth/{tracks,relief,contact,samples}.py,
physics/bridge.py, io/audio_files.py, api.contact_dynamics_for/strike) against the JAX
package on the same inputs made with numpy, and the reference's render properties
(tests/test_render_properties.py) held by the port's CPU render.

The copied numpy modules must give equal arrays and values; the bridge must resolve equal
voices and queue equal strikes for the same contact reports.
"""

import types

import numpy as np
import pytest
import torch

import mesheditor_tpu  # noqa: F401  (enables x64 for the reference)
from mesheditor_tpu import api as jax_api
from mesheditor_tpu.io import audio_files as jax_audio
from mesheditor_tpu.physics import bridge as jax_bridge
from mesheditor_tpu.physics import types as jax_ptypes
from mesheditor_tpu.synth import ModalSynth as JaxModalSynth
from mesheditor_tpu.synth import contact as jax_contact
from mesheditor_tpu.synth import relief as jax_relief
from mesheditor_tpu.synth import samples as jax_samples
from mesheditor_tpu.synth import tracks as jax_tracks
from mesheditor_tpu.types import ModalModes as JaxModalModes

from mesheditor_tpu_torch import api
from mesheditor_tpu_torch.io import audio_files
from mesheditor_tpu_torch.physics import bridge
from mesheditor_tpu_torch.physics import types as ptypes
from mesheditor_tpu_torch.synth import (ContactTrackSpec, ModalEvent, ModalSynth,
                                        SustainedVoice, contact, relief, samples, tracks)
from mesheditor_tpu_torch.types import MassProperties, ModalModes


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_track_equal(a, b):
    assert np.array_equal(a.heights, b.heights) and np.array_equal(a.sums, b.sums)
    assert a.spacing == b.spacing and a.rms == b.rms


# ---- exact copies ----


@pytest.mark.parametrize("corr, slope, spacing, count", [
    (2e-4, -2.0, 1e-6, tracks.TRACK_SAMPLES), (5e-5, -2.5, 1e-6, 4096), (1e-4, -1.6, 2e-6, 3),
    (1e-4, -1.6, 0.0, 64),
])
def test_synthesize_roughness_is_an_exact_copy(corr, slope, spacing, count):
    assert_track_equal(tracks.synthesize_roughness(corr, slope, spacing, count),
                       jax_tracks.synthesize_roughness(corr, slope, spacing, count))


def test_profile_track_reads_and_hash_are_exact_copies():
    rng = np.random.default_rng(4)
    h = rng.standard_normal(1000) * 3e-6
    a, b = tracks.make_profile_track(h, 1e-6), jax_tracks.make_profile_track(h, 1e-6)
    assert_track_equal(a, b)
    for pos in (-1234.5, 0.0, 0.25, 999.75, 1000.0, 3e6 + 0.125):
        assert tracks.track_integral(a, pos) == jax_tracks.track_integral(b, pos)
        for window in (0.5, 1.0, 6.0, 250.0):
            assert tracks.read_track(a, pos, window) == jax_tracks.read_track(b, pos, window)
    assert tracks.hash_params(7, 1e-4, -2.0) == jax_tracks.hash_params(7, 1e-4, -2.0)


def test_relief_track_is_an_exact_copy():
    rng = np.random.default_rng(5)
    nmap = rng.uniform(-1, 1, (8, 6, 3))
    nmap[..., 2] = np.abs(nmap[..., 2]) + 0.2
    path = np.stack([np.linspace(0, 1, 7, endpoint=False), np.linspace(0.1, 0.4, 7)], -1)
    a = relief.relief_track_from_normal_map(nmap, path, 1e-4, count=2048)
    b = jax_relief.relief_track_from_normal_map(nmap, path, 1e-4, count=2048)
    assert_track_equal(a, b)
    assert relief.relief_content_key(3, 1e-4, 2e-4) == jax_relief.relief_content_key(3, 1e-4, 2e-4)
    flat = np.zeros((4, 4, 3))
    flat[..., 2] = 1.0
    assert_track_equal(relief.relief_track_from_normal_map(flat, path, 1e-4, 5e-5, count=256),
                       jax_relief.relief_track_from_normal_map(flat, path, 1e-4, 5e-5, count=256))


def _mass_props(pkg_types):
    quat = np.array([0.9, 0.1, -0.3, 0.2])
    return pkg_types.MassProperties(
        mass=1.7, center_of_mass=np.array([0.01, 0.02, -0.03]),
        inertia_diagonal=np.array([0.02, 0.03, 0.05]),
        inertia_orientation=quat / np.linalg.norm(quat),
    )


CONTACT_CASES = {
    "striker_mass": lambda m, mats: m.striker_mass(m.Striker(mats.STEEL, 0.012, 0.15)),
    "striker_impactor": lambda m, mats: m.striker_impactor(m.Striker()).inv_mass,
    "inverse_inertia_tensor": lambda m, mats: m.inverse_inertia_tensor(_mass_props(m)),
    "inv_effective_modulus": lambda m, mats: m.inv_effective_modulus(
        mats.CERAMIC.properties, mats.STEEL.properties),
    "combined_curvature": lambda m, mats: (m.combined_curvature(10.0, 50.0),
                                           m.combined_curvature(-1.0, 0.0)),
    "contact_stiffness": lambda m, mats: m.contact_stiffness(2e-11, 60.0),
    "contact_patch_radius": lambda m, mats: m.contact_patch_radius(4.0, 2e-11, 60.0),
    "static_penetration": lambda m, mats: (m.static_penetration(4.0, 3e9),
                                           m.static_penetration(4.0, 0.0)),
    "reduced_contact_mass": lambda m, mats: m.reduced_contact_mass(
        _dynamics(m), 1, np.array([0.1, 1.0, 0.2]), m.striker_impactor(m.Striker())),
    "estimate_contact_time": lambda m, mats: [
        m.estimate_contact_time(_dynamics(m), i, np.array([0.1, 1.0, 0.2]), v,
                                mats.CERAMIC.properties, 5.0, m.striker_impactor(m.Striker()))
        for i, v in ((0, 1.0), (2, 0.01), (9, 1.0))],
}


def _dynamics(m):
    arm = np.array([[0.05, 0.0, 0.01], [0.0, 0.07, -0.02], [0.03, 0.03, 0.03]])
    return m.ContactDynamics(mass=1.7, inverse_inertia=m.inverse_inertia_tensor(_mass_props(m)),
                             contact_arm=arm)


@pytest.mark.parametrize("name", CONTACT_CASES)
def test_contact_function_is_an_exact_copy(name):
    from mesheditor_tpu import materials as jax_materials
    from mesheditor_tpu_torch import materials

    # Each contact module carries its package's MassProperties.
    a = np.asarray(CONTACT_CASES[name](types.SimpleNamespace(**vars(contact)), materials),
                   dtype=np.float64)
    b = np.asarray(CONTACT_CASES[name](types.SimpleNamespace(**vars(jax_contact)),
                                       jax_materials), dtype=np.float64)
    assert np.array_equal(a, b), (a, b)


def _fake_result(pkg_modes, mass_props):
    rng = np.random.default_rng(8)
    modes = pkg_modes(np.linspace(300, 5000, 12), np.full(12, 0.4),
                      (rng.standard_normal((5, 12, 3)) * 0.01).astype(np.float32),
                      positions=rng.uniform(-0.1, 0.1, (5, 3)).astype(np.float32))
    return types.SimpleNamespace(modes=modes, mass_props=mass_props)


def test_contact_dynamics_and_strike_match_the_reference():
    from mesheditor_tpu.types import MassProperties as JaxMassProperties

    port_res = _fake_result(ModalModes, _mass_props(types.SimpleNamespace(
        MassProperties=MassProperties)))
    ref_res = _fake_result(JaxModalModes, _mass_props(types.SimpleNamespace(
        MassProperties=JaxMassProperties)))
    a, b = api.contact_dynamics_for(port_res, 1.5), jax_api.contact_dynamics_for(ref_res, 1.5)
    assert a.mass == b.mass
    assert np.array_equal(a.inverse_inertia, b.inverse_inertia)
    assert np.array_equal(a.contact_arm, b.contact_arm)
    port = ModalSynth([port_res.modes], device="cpu")
    ref = JaxModalSynth([ref_res.modes])
    for expos in (0, 3):
        tau_a = api.strike(port, 0, expos, port_res, (0.2, 1.0, 0.1), 0.08, speed=2.0)
        tau_b = jax_api.strike(ref, 0, expos, ref_res, (0.2, 1.0, 0.1), 0.08, speed=2.0)
        assert tau_a == tau_b
    assert [vars(e) for e in port._pending_events] == [vars(e) for e in ref._pending_events]


# ---- the physics bridge ----


def _bridge_pair():
    """The same four bodies registered with the port's and the reference's bridge."""
    rng = np.random.default_rng(9)
    modes = [(np.linspace(200, 6000, 16), np.full(16, 0.3),
              (rng.standard_normal((4, 16, 3)) * 0.01).astype(np.float32)) for _ in range(2)]
    port_synth = ModalSynth([ModalModes(*m) for m in modes] * 2, device="cpu")
    ref_synth = JaxModalSynth([JaxModalModes(*m) for m in modes] * 2)
    positions = rng.uniform(-0.1, 0.1, (4, 3))
    surfaces = ("SURFACE_MACHINED", "SURFACE_SANDBLASTED", "SURFACE_POLISHED", "SURFACE_CAST")

    def make(mod, synth, ctr, mats):
        b = mod.AudioContactBridge(synth)
        for h in range(4):
            dyn = ctr.ContactDynamics(mass=0.5 + h, contact_arm=positions * (1 + 0.1 * h))
            b.register(10 + h, mod.AudioBody(h, dyn, mats.CERAMIC.properties if h % 2 else
                                             mats.STEEL.properties, positions,
                                             getattr(mod, surfaces[h]), curvature=5.0 * h))
        return b

    from mesheditor_tpu import materials as jax_materials
    from mesheditor_tpu_torch import materials

    return (make(bridge, port_synth, contact, materials),
            make(jax_bridge, ref_synth, jax_contact, jax_materials), rng)


def _contacts(pt, rng):
    out = {}
    for c, (a, b) in enumerate(((10, 11), (12, 13), (11, 99), (13, 12))):
        n = rng.normal(size=3)
        out[c] = pt.SustainedContact(
            contact_id=c, body_a=a, body_b=b, point=rng.uniform(-0.1, 0.1, 3),
            normal=n / np.linalg.norm(n), normal_force=float(rng.uniform(0.0, 10.0)),
            slip_speed=float(rng.uniform(0.0, 0.3)), sweep_speed_a=float(rng.uniform(0, 0.3)),
            sweep_speed_b=float(rng.uniform(0.0, 0.3)), friction=0.4, restitution=0.5)
    out[9] = pt.SustainedContact(  # below every floor: not moving
        contact_id=9, body_a=10, body_b=12, point=np.zeros(3), normal=np.array([0, 1.0, 0]),
        normal_force=3.0, slip_speed=0.0, sweep_speed_a=0.001, sweep_speed_b=0.0,
        friction=0.4, restitution=0.5)
    return out


def _voice_fields(v):
    d = dict(vars(v))
    d["tracks"] = [vars(t) for t in v.tracks]
    return {k: np.asarray(x, dtype=object).tolist() if k != "tracks" else x
            for k, x in d.items()}


def test_bridge_resolves_equal_voices():
    port_b, ref_b, rng = _bridge_pair()
    state = rng.bit_generator.state
    port_v = port_b.resolve_voices(_contacts(ptypes, rng), 48_000.0)
    rng.bit_generator.state = state
    ref_v = ref_b.resolve_voices(_contacts(jax_ptypes, rng), 48_000.0)
    assert len(port_v) == len(ref_v) >= 4
    assert [_voice_fields(v) for v in port_v] == [_voice_fields(v) for v in ref_v]
    assert port_b.synth._pool_keys == ref_b.synth._pool_keys
    assert np.array_equal(port_b.synth.pool.heights.numpy(), np.asarray(ref_b.synth.pool.heights))


def test_bridge_queues_equal_strikes():
    port_b, ref_b, rng = _bridge_pair()

    def impacts(pt, seed):
        r = np.random.default_rng(seed)
        out = []
        for a, b in ((10, 11), (12, 99), (13, 10), (11, 12)):
            d = r.normal(size=3)
            out.append(pt.ContactImpact(
                body_a=a, body_b=b, point=r.uniform(-0.1, 0.1, 3), direction=d / np.linalg.norm(d),
                impulse=float(r.uniform(0.0, 1.0)), speed=float(r.uniform(0.0, 3.0)),
                other_inv_mass=float(r.uniform(0.1, 2.0))))
        return out

    port_b.on_impacts(impacts(ptypes, 3))
    ref_b.on_impacts(impacts(jax_ptypes, 3))
    assert len(port_b.synth._pending_events) == len(ref_b.synth._pending_events) > 0
    for a, b in zip(port_b.synth._pending_events, ref_b.synth._pending_events):
        assert a.kind == b.kind and a.obj == b.obj and a.expos == b.expos
        assert np.array_equal(a.j, b.j) and a.pulse_step == b.pulse_step
        assert a.pulse_gamma == b.pulse_gamma and a.accel_amp == b.accel_amp


# ---- samples and WAV files ----


def test_sample_player_is_an_exact_copy():
    rng = np.random.default_rng(12)
    clips = [rng.standard_normal(n).astype(np.float32) for n in (700, 0, 1300)]
    a, b = samples.SamplePlayer(), jax_samples.SamplePlayer()
    for p in (a, b):
        p.set_vertex_samples(2, clips)
        assert p.trigger(2, 0, 0.5) and not p.trigger(2, 1) and p.trigger(2, 2)
    for n in (512, 300, 512, 1024):
        assert np.array_equal(a.mix(n), b.mix(n))
    assert a.active_voices == b.active_voices == 0


def test_wav_files_round_trip_between_packages(tmp_path):
    rng = np.random.default_rng(13)
    x = np.clip(rng.standard_normal((2, 999)) * 0.3, -1, 1).astype(np.float32)
    audio_files.write_wav(tmp_path / "port.wav", x, 44_100)
    jax_audio.write_wav(tmp_path / "ref.wav", x, 44_100)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "ref.wav").read_bytes()
    a, rate_a = audio_files.read_wav(tmp_path / "ref.wav")
    b, rate_b = jax_audio.read_wav(tmp_path / "port.wav")
    assert rate_a == rate_b == 44_100 and np.array_equal(a, b)


# ---- the reference's render properties, on the port's CPU render ----
# tests/test_render_properties.py, case by case. The port renders them through its plain
# version on the CPU; block counts stay as the reference has them except where said.

SAMPLE_RATE = 48_000.0
BLOCK = 512
SAMPLE_POINTS = 4
REST_PEN = 2.0**-18
REST_STIFF = 2.0**31
REST_LOAD = 2.0**4


def make_track() -> tracks.RoughnessTrack:
    rng = np.random.default_rng(0x9E3779B9)
    h = (rng.random(tracks.TRACK_SAMPLES, dtype=np.float64) * 2 - 1).astype(np.float32)
    sums = np.zeros(tracks.TRACK_SAMPLES + 1, np.float32)
    np.cumsum(h, out=sums[1:])
    return tracks.RoughnessTrack(heights=h, sums=sums, spacing=1e-6, rms=1.0)


def make_modes(mode_count: int, longest_t60: float) -> ModalModes:
    freqs = 40.0 * np.arange(1, mode_count + 1) * 1.031
    t60s = longest_t60 / np.arange(1, mode_count + 1)
    shapes = np.zeros((SAMPLE_POINTS, mode_count, 3), np.float32)
    for p in range(SAMPLE_POINTS):
        a = np.arange(1, mode_count + 1) * 0.37 + p
        shapes[p, :, 0] = np.sin(a) * 0.01
        shapes[p, :, 1] = np.cos(a * 1.7) * 0.01
        shapes[p, :, 2] = np.sin(a * 2.3) * 0.01
    positions = np.stack([np.arange(SAMPLE_POINTS) * 0.01, np.zeros(SAMPLE_POINTS),
                          np.zeros(SAMPLE_POINTS)], -1)
    return ModalModes(freqs=freqs, t60s=t60s, shapes=shapes, positions=positions)


def moving_contact(vid: int, obj: int, slot: int) -> SustainedVoice:
    return SustainedVoice(
        voice_id=vid, obj=obj, blend_points=(0, 1, 0), blend_weights=(0.5, 0.5, 0.0),
        normal=(0.0, 1.0, 0.0), slip_dir=(1.0, 0.0, 0.0),
        sweep_dir=((1.0, 0.0, 0.0), (0.0, 0.0, -1.0)), normal_force=REST_LOAD, friction=0.5,
        stiffness=REST_STIFF, static_penetration=REST_PEN, damping_coeff=0.4,
        tracks=tuple(ContactTrackSpec(index=slot, rate=0.4, sigma=2e-7, window=8.0, step=4e-7)
                     for _ in range(4)),
    )


def resting_contact(vid: int, obj: int, slot: int) -> SustainedVoice:
    v = moving_contact(vid, obj, slot)
    return SustainedVoice(
        voice_id=v.voice_id, obj=v.obj, blend_points=v.blend_points,
        blend_weights=v.blend_weights, normal=v.normal,
        slip_dir=(0.0, 0.0, 0.0), sweep_dir=((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
        normal_force=v.normal_force, friction=v.friction, stiffness=v.stiffness,
        static_penetration=v.static_penetration, damping_coeff=v.damping_coeff,
        tracks=tuple(ContactTrackSpec(index=slot, rate=0.0, sigma=2e-7, window=8.0, step=0.0)
                     for _ in range(4)),
    )


def silent_contact(vid: int, obj: int) -> SustainedVoice:
    return SustainedVoice(voice_id=vid, obj=obj, blend_points=(0, 1, 0),
                          blend_weights=(0.5, 0.5, 0.0), normal=(0.0, 1.0, 0.0))


def make_scene(object_count: int, mode_count: int, longest_t60: float):
    modes = make_modes(mode_count, longest_t60)
    synth = ModalSynth([modes] * object_count, gains=[1.0] * object_count,
                       sample_rate=SAMPLE_RATE, device="cpu")
    return synth, synth.adopt_track(1, make_track)


def strike_all(synth: ModalSynth, impulse: float) -> None:
    for o in range(synth.params.coeff_re.shape[0]):
        synth.enqueue(ModalEvent(kind="impact", obj=o, expos=0, j=(impulse, 0.5 * impulse, 0.0),
                                 pulse_step=1.0 / 300.0, pulse_gamma=20.0, accel_amp=0.0))


def render_blocks(synth, blocks: int, frames: int, publish=None) -> np.ndarray:
    signal = np.zeros(blocks * frames, np.float32)
    for b in range(blocks):
        if publish is not None:
            synth.publish_voices(publish)
        signal[b * frames : (b + 1) * frames] = synth.render(frames).numpy()
    return signal


def peak(x) -> float:
    return float(np.abs(x).max()) if x.size else 0.0


def rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def _contact_at_rest_excites_nothing():
    synth, slot = make_scene(1, 64, 0.2)
    signal = render_blocks(synth, 8, BLOCK, publish=[resting_contact(1, 0, slot)])
    assert peak(signal) == 0.0


def _coupling_loop_decays():
    t60 = 0.2
    synth, slot = make_scene(1, 64, t60)
    strike_all(synth, 1.0)
    blocks = int(5 * t60 * SAMPLE_RATE / BLOCK)
    signal = render_blocks(synth, blocks, BLOCK, publish=[resting_contact(1, 0, slot)])
    assert np.isfinite(signal).all()
    assert peak(signal) > 0
    assert peak(signal[-BLOCK:]) < peak(signal) * 1e-9


def _moving_contact_settles():
    # 128 blocks (the reference: 256): the property compares the last quarter with the
    # third, both long past the attack transient at either length.
    synth, slot = make_scene(1, 64, 0.2)
    signal = render_blocks(synth, 128, BLOCK, publish=[moving_contact(1, 0, slot)])
    assert np.isfinite(signal).all()
    q = signal.size // 4
    assert peak(signal[2 * q : 3 * q]) > 0
    assert peak(signal[-q:]) < peak(signal[2 * q : 3 * q]) * 2.0


def _coupling_damps_not_drives():
    def smooth_track():
        t = np.arange(tracks.TRACK_SAMPLES) / tracks.TRACK_SAMPLES
        h = np.sin(2 * np.pi * 16 * t).astype(np.float32)
        sums = np.zeros(tracks.TRACK_SAMPLES + 1, np.float32)
        np.cumsum(h, out=sums[1:])
        return tracks.RoughnessTrack(heights=h, sums=sums, spacing=1e-6, rms=1.0)

    def render(coupling):
        synth, _ = make_scene(1, 64, 0.2)
        slot = synth.adopt_track(2, smooth_track)
        synth.coupling = coupling
        signal = render_blocks(synth, 64, BLOCK, publish=[moving_contact(1, 0, slot)])
        return rms(signal[signal.size // 2 :])

    open_loop = render(0.0)
    coupled = render(1.0)
    strongly_coupled = render(100.0)
    assert open_loop > 0
    assert coupled < open_loop
    assert strongly_coupled < coupled
    assert strongly_coupled < 0.99 * open_loop


def _voice_open_is_immune_to_mirror_mutation():
    offsets = np.arange(4) * (tracks.TRACK_SAMPLES / 4)
    for _ in range(4):
        synth, slot = make_scene(1, 8, 0.2)
        synth.publish_voices([moving_contact(1, 0, slot)])
        synth.render(BLOCK)
        row = synth._voice_ids[1]
        pos = synth.voices.pos_base[row].numpy()
        assert np.array_equal(pos, offsets), pos


def _silent_contact_leaves_strike_alone():
    def render(with_voice):
        synth, _ = make_scene(1, 200, 0.2)
        strike_all(synth, 1.0)
        publish = [silent_contact(1, 0)] if with_voice else None
        return render_blocks(synth, 16, BLOCK, publish=publish)

    without = render(False)
    with_voice = render(True)
    assert peak(without) > 0
    assert peak(without - with_voice) < peak(without) * 1e-5


def _block_boundary_invariance_exact():
    def render(blocks, frames):
        synth, slot = make_scene(1, 64, 0.2)
        return render_blocks(synth, blocks, frames, publish=[moving_contact(1, 0, slot)])

    whole = render(8, 1024)
    split = render(32, 256)
    assert peak(whole) > 0
    assert np.array_equal(whole, split)


def _strike_rings_and_decays():
    synth, _ = make_scene(1, 64, 0.05)
    strike_all(synth, 1.0)
    signal = render_blocks(synth, 64, BLOCK)
    assert np.isfinite(signal).all()
    assert peak(signal[:BLOCK]) > 0
    assert peak(signal[-BLOCK:]) < peak(signal) * 1e-4


def _silence_event_clears_state():
    synth, _ = make_scene(2, 32, 1.0)
    strike_all(synth, 1.0)
    render_blocks(synth, 4, BLOCK)
    synth.silence(0)
    synth.silence(1)
    assert peak(render_blocks(synth, 4, BLOCK)) == 0.0


def _voice_idle_timeout_silences():
    synth, slot = make_scene(1, 64, 0.2)
    render_blocks(synth, 16, BLOCK, publish=[moving_contact(1, 0, slot)])
    assert synth.active_voices == 1
    render_blocks(synth, 16, BLOCK)  # past the 0.1 s idle window (~9.4 blocks)
    assert synth.active_voices == 0


def _polyphony_objects_independent():
    synth1, _ = make_scene(1, 64, 0.2)
    strike_all(synth1, 1.0)
    one = render_blocks(synth1, 8, BLOCK)
    synth2, _ = make_scene(4, 64, 0.2)
    strike_all(synth2, 1.0)
    four = render_blocks(synth2, 8, BLOCK)
    assert np.allclose(four, 4 * one, rtol=1e-4, atol=peak(one) * 1e-5)


RENDER_PROPERTIES = {
    "contact_at_rest_excites_nothing": _contact_at_rest_excites_nothing,
    "coupling_loop_decays": _coupling_loop_decays,
    "moving_contact_settles": _moving_contact_settles,
    "coupling_damps_not_drives": _coupling_damps_not_drives,
    "voice_open_is_immune_to_mirror_mutation": _voice_open_is_immune_to_mirror_mutation,
    "silent_contact_leaves_strike_alone": _silent_contact_leaves_strike_alone,
    "block_boundary_invariance_exact": _block_boundary_invariance_exact,
    "strike_rings_and_decays": _strike_rings_and_decays,
    "silence_event_clears_state": _silence_event_clears_state,
    "voice_idle_timeout_silences": _voice_idle_timeout_silences,
    "polyphony_objects_independent": _polyphony_objects_independent,
}


@pytest.mark.parametrize("name", RENDER_PROPERTIES)
def test_render_property(name):
    RENDER_PROPERTIES[name]()
