"""Port sustained-contact render (mesheditor_tpu_torch/synth/{bank,render,coupled,engine,
stream}.py): the voice table and its packed upload, the block precompute, the coupled block
through the plain version of the CUDA kernel, and the engine's publish/adopt/idle protocol,
each against the JAX package on the same inputs made with numpy (the reference's scan
render_block_impl, and its Pallas coupled kernel in interpret mode, as its own tests run
it on the CPU); where a card exists, the kernel against the plain version.

The JAX reference is imported inside a fixture, so that the card test runs on a machine
with no JAX: python -m pytest --noconftest -m cuda tests/test_torch_sustained.py
"""

import types

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch import convert
from mesheditor_tpu_torch.synth import (ContactTrackSpec, ModalSynth, SustainedVoice, coupled,
                                        impact)
from mesheditor_tpu_torch.synth.bank import VoiceTable, apply_voice_state
from mesheditor_tpu_torch.synth.render import _voice_gain_rows, voice_block
from mesheditor_tpu_torch.synth.stream import AudioStream
from mesheditor_tpu_torch.synth.tracks import synthesize_roughness
from mesheditor_tpu_torch.types import ModalModes
from test_torch_impact import BANK_FIELDS, IMPACT_FIELDS, make_scene, port_scene

VOICE_FIELDS = VoiceTable.FIELDS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def voice_rows(n_obj, n_voice):
    """tests/test_pallas_coupled.py:add_voices's packed rows: (V, 36) f32, (V, 10) i32;
    the last row stays inactive."""
    f32 = np.zeros((n_voice, 36), np.float32)
    i32 = np.zeros((n_voice, 10), np.int32)
    for v in range(max(n_voice - 1, 1)):
        f32[v, 0:3] = [0.5, 0.3, 0.2]
        f32[v, 3:6] = [0, 1, 0]
        f32[v, 6:9] = [1, 0, 0]
        f32[v, 9:15] = [1, 0, 0, 0, 0, -1]
        f32[v, 15] = 4.0
        f32[v, 16] = 0.4
        f32[v, 17] = 2.0**28
        f32[v, 18] = 2.0**-20
        f32[v, 19] = 0.3
        f32[v, 20:24] = 0.4
        f32[v, 24:28] = 2e-7
        f32[v, 28:32] = 6.0
        f32[v, 32:36] = 4e-7
        i32[v, 0] = v % n_obj
        i32[v, 1:4] = [0, 1, 2]
        i32[v, 8] = 1
        i32[v, 9] = 1
    return f32, i32


def voice_rows_on(objs, loads=None):
    """add_voices' rows for one live voice on each object of `objs`, in table order, with
    normal forces `loads` (default 4 N)."""
    n = len(objs)
    f32, i32 = voice_rows(1, n + 1)
    f32, i32 = f32[:n].copy(), i32[:n].copy()
    i32[:, 0] = objs
    if loads is not None:
        f32[:, 15] = loads
    return f32, i32


def pool_rows(slots=2, n=512):
    rng = np.random.default_rng(11)
    heights = np.zeros((slots, n), np.float32)
    sums = np.zeros((slots, n + 1), np.float32)
    heights[0] = rng.standard_normal(n).astype(np.float32)
    np.cumsum(heights[0], out=sums[0, 1:])
    return heights, sums


def coupled_scene(seed_scene=None):
    """test_pallas_coupled.py:53-74's scene: make_scene(4, 32, 8, 1) + add_voices(4, 4)."""
    bank, imp = seed_scene or make_scene(n_obj=4, k=32, n_imp=8, impacts_per_obj=1)
    return bank, imp, voice_rows(4, 4), pool_rows()


def three_impact_scene():
    """A second seed with three live impacts on object 1 (R = 3)."""
    bank, imp = make_scene(n_obj=4, k=32, n_imp=8, impacts_per_obj=1, seed=17)
    imp["active"][4:6] = True
    imp["obj"][4:6] = 1
    return coupled_scene((bank, imp))


def port_coupled(scene, device="cpu"):
    bank, imp, (f32, i32), (heights, sums) = scene
    params, state, table = port_scene(bank, imp, device)
    voices = apply_voice_state(VoiceTable.empty(len(f32), device),
                               torch.tensor(f32, device=device), torch.tensor(i32, device=device))
    return params, state, table, voices, convert.track_pool(heights, sums, device=device)


def slots(imp):
    live = imp["obj"][imp["active"]]
    return int(np.bincount(live).max()) if live.size else 0


@pytest.fixture(scope="module")
def ref():
    import mesheditor_tpu  # noqa: F401  (enables x64)
    import jax.numpy as jnp
    from mesheditor_tpu.synth import ContactTrackSpec as JaxTrackSpec
    from mesheditor_tpu.synth import ModalSynth as JaxModalSynth
    from mesheditor_tpu.synth import SustainedVoice as JaxVoice
    from mesheditor_tpu.synth.bank import (BankParams, BankState, ImpactTable, TrackPool,
                                           VoiceTable as JaxVoiceTable)
    from mesheditor_tpu.synth.bank import apply_voice_state as jax_apply
    from mesheditor_tpu.synth.pallas_coupled import render_block_coupled_pallas
    from mesheditor_tpu.synth.render import _voice_gain_rows as jax_gain_rows
    from mesheditor_tpu.synth.render import render_block_impl
    from mesheditor_tpu.synth.stream import AudioStream as JaxAudioStream
    from mesheditor_tpu.types import ModalModes as JaxModalModes

    def scene(s):
        bank, imp, (f32, i32), (heights, sums) = s
        params = BankParams(**{f: jnp.asarray(bank[f], jnp.float32) for f in BANK_FIELDS},
                            sample_rate=bank["sample_rate"])
        state = BankState(jnp.asarray(bank["z_re"], jnp.float32),
                          jnp.asarray(bank["z_im"], jnp.float32))
        dt = {"active": bool, "obj": jnp.int32, "expos": jnp.int32, "age": jnp.int32,
              "total": jnp.int32}
        table = ImpactTable(**{f: jnp.asarray(imp[f], dt.get(f, jnp.float32))
                               for f in IMPACT_FIELDS})
        voices = jax_apply(JaxVoiceTable.empty(len(f32)), jnp.asarray(f32), jnp.asarray(i32))
        return params, state, table, voices, TrackPool(jnp.asarray(heights), jnp.asarray(sums))

    def scan(s, n, **kw):
        return render_block_impl(*scene(s), n, click_gain=1.0, **kw)

    def pallas(s, n):
        return render_block_coupled_pallas(*scene(s), n, 1.0, 1.0, 1.0)

    return types.SimpleNamespace(
        scene=scene, scan=scan, impl=render_block_impl, pallas=pallas, apply=jax_apply,
        VoiceTable=JaxVoiceTable,
        gain_rows=jax_gain_rows, ModalSynth=JaxModalSynth, ModalModes=JaxModalModes,
        SustainedVoice=JaxVoice, ContactTrackSpec=JaxTrackSpec, AudioStream=JaxAudioStream,
        jnp=jnp)


def port_voices(jax_voices):
    return convert.voice_table(**{f: np.asarray(getattr(jax_voices, f)) for f in VOICE_FIELDS})


def test_apply_voice_state_matches_reference(ref):
    f32, i32 = voice_rows(4, 6)
    port = apply_voice_state(VoiceTable.empty(6, "cpu"), torch.tensor(f32), torch.tensor(i32))
    jax_t = ref.apply(ref.VoiceTable.empty(6), ref.jnp.asarray(f32), ref.jnp.asarray(i32))
    # A second publish: rows 0-1 persist (no reset), row 2 reopens (reset).
    f32[:, 15] += 1.0
    i32[:, 9] = 0
    i32[2, 9] = 1
    port = port.replace(age=port.age + 100, relief_mean=port.relief_mean + 1e-7,
                        primed=torch.ones_like(port.primed))
    jax_t = ref.apply(jax_t.__class__(**{**{f: getattr(jax_t, f) for f in VOICE_FIELDS},
                                         "age": jax_t.age + 100,
                                         "relief_mean": jax_t.relief_mean + 1e-7,
                                         "primed": ref.jnp.ones_like(jax_t.primed)}),
                      ref.jnp.asarray(f32), ref.jnp.asarray(i32))
    port = apply_voice_state(port, torch.tensor(f32), torch.tensor(i32))
    for f in VOICE_FIELDS:
        a, b = getattr(port, f).numpy(), np.asarray(getattr(jax_t, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("primed", [False, True])
def test_block_precompute_matches_reference(ref, primed):
    """Heights, relief, slopes and the primed carries against render_block_impl's debug
    output, and the gain rows against its _voice_gain_rows, at rtol 1e-6 (track positions
    are float64 on both sides)."""
    scene = coupled_scene()
    params, state, table, voices, pool = ref.scene(scene)
    p_params, _state, _table, p_voices, p_pool = port_coupled(scene)
    if primed:  # a second block: the voices carry primed relief means and positions
        state, table, voices, _out = ref.scan(scene, 700)
        p_voices = port_voices(voices)
    n = 300
    *_, dbg = ref.impl(params, state, table, voices, pool, n, click_gain=1.0, debug=True)
    vb = voice_block(p_params, p_voices, p_pool, n, 1.0)
    for name, got in (("heights", vb.heights), ("relief", vb.relief), ("slope0", vb.slope0),
                      ("slope1", vb.slope1), ("rm0", vb.rm0)):
        want = np.asarray(dbg[name])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)
    for got, want in zip(_voice_gain_rows(p_params, p_voices, 1.0),
                         ref.gain_rows(params, voices, 1.0)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def assert_coupled_close(port, reference, what):
    """tests/test_pallas_coupled.py:66-74's tolerances."""
    s_t, i_t, v_t, out_t = port
    s_j, i_j, v_j, out_j = reference
    out_j = np.asarray(out_j)
    peak = max(np.abs(out_j).max(), 1e-12)
    assert np.abs(out_t.numpy() - out_j).max() < 5e-5 * peak, what
    assert np.allclose(s_t.z_im.numpy(), np.asarray(s_j.z_im), rtol=1e-3, atol=peak * 1e-6), what
    assert np.allclose(v_t.relief_mean.numpy(), np.asarray(v_j.relief_mean), rtol=1e-5,
                       atol=1e-12), what
    assert np.allclose(v_t.penetration.numpy(), np.asarray(v_j.penetration), rtol=1e-4,
                       atol=1e-12), what
    assert np.array_equal(v_t.age.numpy(), np.asarray(v_j.age)), what
    assert np.array_equal(i_t.active.numpy(), np.asarray(i_j.active)), what
    assert np.array_equal(i_t.age.numpy(), np.asarray(i_j.age)), what


def test_coupled_block_matches_scan(ref):
    scene = coupled_scene()
    port = coupled.render_block_coupled(*port_coupled(scene), 256, 1.0, 1.0, 1.0, 1)
    assert_coupled_close(port, ref.scan(scene, 256, sustain_level=1.0, coupling=1.0), "scan")


def test_coupled_block_matches_pallas_kernel(ref):
    scene = coupled_scene()
    port = coupled.render_block_coupled(*port_coupled(scene), 256, 1.0, 1.0, 1.0, 1)
    assert_coupled_close(port, ref.pallas(scene, 256), "pallas (interpret)")


def test_three_impacts_on_one_object_match_scan(ref):
    scene = three_impact_scene()
    assert slots(scene[1]) == 3
    port = coupled.render_block_coupled(*port_coupled(scene), 300, 1.0, 1.0, 1.0, 3)
    assert_coupled_close(port, ref.scan(scene, 300), "R=3")


@pytest.mark.parametrize("n_samples", [1, 256, 300])
def test_coupled_block_boundary_invariance_is_bit_exact(n_samples):
    scene = three_impact_scene()
    sc = port_coupled(scene)
    r = slots(scene[1])
    s1, i1, v1, o1 = coupled.render_block_coupled(*sc, n_samples, 1.0, 1.0, 1.0, r)
    s2, i2, v2, o2 = coupled.render_block_coupled(sc[0], s1, i1, v1, sc[4], n_samples, 1.0,
                                                  1.0, 1.0, r)
    s12, i12, v12, o12 = coupled.render_block_coupled(*sc, 2 * n_samples, 1.0, 1.0, 1.0, r)
    assert torch.equal(o12, torch.cat([o1, o2]))
    assert torch.equal(s12.z_re, s2.z_re) and torch.equal(s12.z_im, s2.z_im)
    for f in ("relief_mean", "penetration", "prev_height", "age", "primed"):
        assert torch.equal(getattr(v12, f), getattr(v2, f)), f
    assert torch.equal(i12.age, i2.age) and torch.equal(i12.active, i2.active)


@pytest.mark.parametrize("which", ["scan", "pallas"])
def test_main_path_layout_matches_reference(ref, which):
    """The sustained main path's voice layout (one voice on each of the first quarter of
    the objects, the rest voice-free), scaled down to 16 objects x 32 modes with voices on
    objects 0-7, S=256: the plain coupled version against the reference's scan and its
    Pallas kernel (interpret mode), at test_pallas_coupled.py's tolerances."""
    bank, imp = make_scene(n_obj=16, k=32, n_imp=16, impacts_per_obj=1, seed=9)
    scene = (bank, imp, voice_rows_on(np.arange(8)), pool_rows())
    port = coupled.render_block_coupled(*port_coupled(scene), 256, 1.0, 1.0, 1.0, 1)
    want = (ref.scan(scene, 256, sustain_level=1.0, coupling=1.0) if which == "scan"
            else ref.pallas(scene, 256))
    assert_coupled_close(port, want, which)


def test_group_voices_layout():
    v_obj = torch.tensor([2, -1, 0, 2, 2, 5, 0, 1], dtype=torch.int32)
    order, offsets = coupled._group_voices(v_obj, 4, 2)
    # object 0: rows 2, 6; object 1: row 7; object 2: rows 0, 3 (row 4 ranks third: dropped);
    # rows 1 (no object) and 5 (past the bank) are not stepped
    assert offsets.tolist() == [0, 2, 3, 5, 5]
    assert order[:5].tolist() == [2, 6, 7, 0, 3]
    assert sorted(order[5:].tolist()) == [1, 4, 5]


def _voice(pkg, vid, obj, slot, load=4.0):
    return pkg.SustainedVoice(
        voice_id=vid, obj=obj, blend_points=(0, 1, 0), blend_weights=(0.5, 0.5, 0.0),
        normal=(0.0, 1.0, 0.0), slip_dir=(1.0, 0.0, 0.0),
        sweep_dir=((1.0, 0.0, 0.0), (0.0, 0.0, -1.0)), normal_force=load, friction=0.4,
        stiffness=2.0**28, static_penetration=2.0**-20, damping_coeff=0.3,
        tracks=tuple(pkg.ContactTrackSpec(index=slot, rate=0.4 + 0.1 * t, sigma=2e-7,
                                          window=6.0, step=4e-7) for t in range(3)),
    )


def test_engine_matches_reference_engine_with_voices(ref):
    """The port's ModalSynth against the reference's (scan path on the CPU) over a script of
    strikes, publishes and blocks: a voice opens, is kept, ends by omission; a voice past
    max_voices is refused and one past the bank skipped; a silence event ends its object's
    voice; the idle timeout ends the set after a publish gap longer than 0.1 s."""
    rng = np.random.default_rng(21)
    freqs, t60s = np.linspace(150, 6000, 24), np.linspace(0.8, 0.1, 24)
    shapes = (rng.standard_normal((3, 24, 3)) * 0.02).astype(np.float32)
    port = ModalSynth([ModalModes(freqs, t60s, shapes)] * 3, gains=[1.0, 0.5, 2.0],
                      max_impacts=8, max_voices=2, device="cpu")
    jax_synth = ref.ModalSynth([ref.ModalModes(freqs, t60s, shapes)] * 3, gains=[1.0, 0.5, 2.0],
                               max_impacts=8, max_voices=2)
    port_pkg = types.SimpleNamespace(SustainedVoice=SustainedVoice,
                                     ContactTrackSpec=ContactTrackSpec)
    slot = port.adopt_track(5, lambda: synthesize_roughness(2e-4, -2.0, 1e-6))
    assert jax_synth.adopt_track(5, lambda: synthesize_roughness(2e-4, -2.0, 1e-6)) == slot

    def voices(pkg, spec):
        return [_voice(pkg, vid, obj, slot, load) for vid, obj, load in spec]

    script = [  # (events, published voices or None, expected live voices after the block)
        ([("strike", 0)], [(1, 0, 4.0)], 1),  # voice 1 opens
        ([], [(1, 0, 4.5), (2, 1, 3.0)], 2),  # kept, voice 2 opens
        ([("strike", 2)], [(1, 0, 4.5), (2, 1, 3.0), (3, 2, 2.0), (4, 9, 2.0)], 2),  # 3 refused
        ([], [(2, 1, 3.0), (3, 2, 2.0)], 2),  # 1 ends by omission, 3 opens
        # The silence ends voice 2; the standing set still names it, so it reopens fresh.
        ([("silence", 1)], None, 2),
    ] + [([], None, 2)] * 8 + [([], None, 0)]  # the idle timeout (0.1 s) ends the set
    for events, spec, live in script:
        for synth, pkg in ((port, port_pkg), (jax_synth, ref)):
            for kind, obj in events:
                if kind == "strike":
                    synth.strike(obj, 1, (0.3, 0.1, 0.05), 0.002, accel_amp=0.001)
                else:
                    synth.silence(obj)
            if spec is not None:
                synth.publish_voices(voices(pkg, spec))
        a = port.render(512).numpy()
        b = np.asarray(jax_synth.render(512))
        assert np.abs(a - b).max() < 5e-5 * max(np.abs(b).max(), 1e-12)
        assert port.active_voices == jax_synth.active_voices == live
        assert port._voice_ids == jax_synth._voice_ids
        assert np.array_equal(port._voice_f32, jax_synth._voice_f32)
        assert np.array_equal(port._voice_i32, jax_synth._voice_i32)
    for counter in ("voices_refused", "tracks_refused", "events_dropped"):
        assert getattr(port, counter) == getattr(jax_synth, counter), counter
    assert port.voices_refused == 1
    assert port.active_impacts == jax_synth.active_impacts


def test_audio_stream_and_retune_match_reference(ref, tmp_path):
    rng = np.random.default_rng(22)
    freqs, t60s = np.linspace(300, 5000, 16), np.full(16, 0.3)
    shapes = (rng.standard_normal((2, 16, 3)) * 0.02).astype(np.float32)
    port = AudioStream(ModalSynth([ModalModes(freqs, t60s, shapes)] * 2, device="cpu"))
    jax_stream = ref.AudioStream(ref.ModalSynth([ref.ModalModes(freqs, t60s, shapes)] * 2))
    clip = rng.standard_normal(700).astype(np.float32) * 0.01
    for s in (port, jax_stream):
        s.synth.strike(1, 1, (0.2, 0.3, 0.0), 0.002)
        s.synth.retune(0, freqs * 1.5, t60s)
        s.synth.strike(0, 0, (0.1, 0.0, 0.2), 0.003)
        s.play_sample(clip, gain=0.5)
        s.start_recording()
    for _ in range(3):
        a, b = port.process_block(), jax_stream.process_block()
        assert isinstance(a, np.ndarray) and a.shape == (512,)
        assert np.abs(a - b).max() < 5e-5 * np.abs(b).max()
    assert np.array_equal(port.synth.params.coeff_re.numpy(),
                          np.asarray(jax_stream.synth.params.coeff_re))
    rec = port.stop_recording()
    assert rec.shape == (1536,) and np.isfinite(rec).all()
    port.render_to_wav(tmp_path / "out.wav", 0.02)
    assert (tmp_path / "out.wav").stat().st_size > 44


@pytest.mark.cuda
def test_coupled_kernel_matches_plain_on_card():
    """Input 1 of the chip check: the reference's coupled test scene, kernel against the
    plain version at test_pallas_coupled.py's tolerances; the same card tensors through
    both recurrences; 2S bit-equal to S then S."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    scene = coupled_scene()
    before, impact_before = coupled.LAUNCHES, impact.LAUNCHES
    kern = coupled.render_block_coupled(*port_coupled(scene, "cuda"), 256, 1.0, 1.0, 1.0, 1)
    assert coupled.LAUNCHES == before + 1 and impact.LAUNCHES == impact_before
    plain = coupled.render_block_coupled(*port_coupled(scene), 256, 1.0, 1.0, 1.0, 1)
    s_k, i_k, v_k, o_k = kern
    s_p, i_p, v_p, o_p = plain
    peak = float(o_p.abs().max())
    assert float((o_k.cpu() - o_p).abs().max()) < 5e-5 * peak
    assert torch.allclose(s_k.z_im.cpu(), s_p.z_im, rtol=1e-3, atol=1e-6 * peak)
    assert torch.allclose(v_k.relief_mean.cpu(), v_p.relief_mean, rtol=1e-5, atol=1e-12)
    assert torch.allclose(v_k.penetration.cpu(), v_p.penetration, rtol=1e-4, atol=1e-12)
    assert torch.equal(v_k.age.cpu(), v_p.age) and torch.equal(i_k.age.cpu(), i_p.age)
    sc = port_coupled(scene, "cuda")
    s1, i1, v1, o1 = coupled.render_block_coupled(*sc, 256, 1.0, 1.0, 1.0, 1)
    s2, _i2, v2, o2 = coupled.render_block_coupled(sc[0], s1, i1, v1, sc[4], 256, 1.0, 1.0,
                                                   1.0, 1)
    s12, _i12, v12, o12 = coupled.render_block_coupled(*sc, 512, 1.0, 1.0, 1.0, 1)
    assert torch.equal(o12, torch.cat([o1, o2]))
    assert torch.equal(s12.z_im, s2.z_im) and torch.equal(v12.penetration, v2.penetration)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


def kernel_scene(k, per_obj, seed=5):
    """Three objects of k modes, one impact each: per_obj voices on object 0, none on
    object 1, one on object 2, interleaved in table order (per_obj == 256: 256 voices on
    object 0 alone); loads 0.1-6 N, so the knee fires on some. Returns (scene, n_per_obj)."""
    rng = np.random.default_rng(seed)
    bank, imp = make_scene(n_obj=3, k=k, n_imp=6, impacts_per_obj=1, seed=seed)
    if per_obj == 256:
        objs = [0] * 256
    else:
        objs = [0] * per_obj
        objs.insert(per_obj // 2, 2)
    loads = rng.uniform(0.1, 6.0, len(objs)).astype(np.float32)
    return (bank, imp, voice_rows_on(objs, loads), pool_rows()), max(per_obj, 1)


def assert_kernel_matches_plain(scene, n_samples, n_per_obj):
    """resonate_coupled on the card against the plain version on host copies of the same
    inputs, at test_pallas_coupled.py's tolerances; voices past n_per_obj keep their carries
    exactly."""
    r = slots(scene[1])
    args_k, _vb, _c = coupled.coupled_inputs(*port_coupled(scene, "cuda"), n_samples, 1.0, 1.0,
                                             1.0, r, n_per_obj)
    args_p, _vb, _c = coupled.coupled_inputs(*port_coupled(scene), n_samples, 1.0, 1.0, 1.0,
                                             r, n_per_obj)
    before = coupled.LAUNCHES
    kern = [t.cpu() for t in coupled.resonate_coupled(*args_k)]
    assert coupled.LAUNCHES == before + 1
    plain = coupled.resonate_coupled(*args_p)
    peak = float(plain[0].abs().max())
    assert torch.isfinite(kern[0]).all()
    assert float((kern[0] - plain[0]).abs().max()) < 5e-5 * peak
    assert torch.allclose(kern[2], plain[2], rtol=1e-3, atol=1e-6 * peak)
    assert torch.allclose(kern[3], plain[3], rtol=1e-5, atol=1e-12)
    assert torch.allclose(kern[4], plain[4], rtol=1e-4, atol=1e-12)
    order, offsets = coupled._group_voices(args_p[12], args_p[0].shape[0], n_per_obj)
    dropped = order[int(offsets[-1]):].long()
    assert torch.equal(kern[3][dropped], args_p[10][dropped])
    assert torch.equal(kern[4][dropped], args_p[11][dropped])


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples", [1, 31, 32, 33, 512])
@pytest.mark.parametrize("k, per_obj", [(k, v) for k in (96, 200, 256, 1024)
                                        for v in (0, 1, 4, 5, 33)] + [(200, 256)])
def test_coupled_kernel_paths_match_plain_on_card(k, per_obj, n_samples):
    """Both launch paths (warp: K <= 256 with at most four voices an object; block:
    K = 1024, or five or more voices) and the edges of the 32-sample mix run, against the
    plain version."""
    _needs_card()
    scene, n_per_obj = kernel_scene(k, per_obj)
    assert_kernel_matches_plain(scene, n_samples, n_per_obj)


@pytest.mark.cuda
@pytest.mark.parametrize("k, n_per_obj", [(96, 2), (256, 1), (200, 5)])
def test_in_kernel_voice_set_matches_group_voices_on_card(k, n_per_obj):
    """Voices ranked past n_per_obj on their object, voices on no object and past the bank:
    the kernel steps the set _group_voices keeps, in its order, and leaves the rest."""
    _needs_card()
    objs = [2, 0, 2, 2, 0, 1, 2, 0, 0, 2, 1, 0, 2, 2]
    scene = kernel_scene(k, 1)[0][:2] + (voice_rows_on(objs), pool_rows())
    assert_kernel_matches_plain(scene, 100, n_per_obj)
    r = slots(scene[1])
    args, _vb, _c = coupled.coupled_inputs(*port_coupled(scene, "cuda"), 100, 1.0, 1.0, 1.0, r,
                                           n_per_obj)
    v_obj = torch.tensor([2, -1, 0, 2, 2, 5, 0, 1, 2, 0, 7, 0, 2, 2], dtype=torch.int32)
    args_k = args[:12] + (v_obj.cuda(), n_per_obj)
    args_p = tuple(a.cpu() if torch.is_tensor(a) else a for a in args_k)
    kern = [t.cpu() for t in coupled.resonate_coupled(*args_k)]
    plain = coupled.resonate_coupled(*args_p)
    peak = float(plain[0].abs().max())
    assert float((kern[0] - plain[0]).abs().max()) < 5e-5 * peak
    assert torch.allclose(kern[3], plain[3], rtol=1e-5, atol=1e-12)
    assert torch.equal(kern[3] == args_p[10], plain[3] == args_p[10])


@pytest.mark.cuda
@pytest.mark.parametrize("k, per_obj", [(256, 1), (96, 4), (200, 5), (1024, 1)])
def test_coupled_kernel_two_s_equals_s_plus_s_on_card(k, per_obj):
    """Rendering 2S samples equals S then S, bit for bit, on both paths, with S = 300 (not
    a multiple of the 32-sample mix run)."""
    _needs_card()
    scene, n_per_obj = kernel_scene(k, per_obj)
    sc = port_coupled(scene, "cuda")
    r = slots(scene[1])
    s1, i1, v1, o1 = coupled.render_block_coupled(*sc, 300, 1.0, 1.0, 1.0, r, n_per_obj)
    s2, _i2, v2, o2 = coupled.render_block_coupled(sc[0], s1, i1, v1, sc[4], 300, 1.0, 1.0,
                                                   1.0, r, n_per_obj)
    s12, _i12, v12, o12 = coupled.render_block_coupled(*sc, 600, 1.0, 1.0, 1.0, r, n_per_obj)
    assert torch.equal(o12, torch.cat([o1, o2]))
    assert torch.equal(s12.z_re, s2.z_re) and torch.equal(s12.z_im, s2.z_im)
    assert torch.equal(v12.relief_mean, v2.relief_mean)
    assert torch.equal(v12.penetration, v2.penetration)
