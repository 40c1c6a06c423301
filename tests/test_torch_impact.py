"""Port impact render (mesheditor_tpu_torch/synth/impact.py): the plain version of the
CUDA resonator kernel against the JAX package's Pallas impact kernel (run in interpret
mode, as its own tests run it on the CPU) and against its lax.scan render_block_impl, on
the same scenes made with numpy; block-boundary invariance; the engine end to end; and,
where a card exists, the kernel against the plain version.

The JAX reference is imported inside a fixture, so that the card test runs on a machine
with no JAX: python -m pytest --noconftest -m cuda tests/test_torch_impact.py
"""

import types

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch import convert
from mesheditor_tpu_torch.synth import ModalEvent, ModalSynth, impact
from mesheditor_tpu_torch.types import ModalModes

BANK_FIELDS = ("coeff_re", "coeff_im", "disp_scale", "shapes", "out_gain")
IMPACT_FIELDS = ("active", "obj", "expos", "j", "pulse_step", "gamma", "accel_amp", "age",
                 "total")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref():
    import mesheditor_tpu  # noqa: F401  (enables x64)
    import jax.numpy as jnp
    from mesheditor_tpu.synth import ModalEvent as JaxModalEvent
    from mesheditor_tpu.synth import ModalSynth as JaxModalSynth
    from mesheditor_tpu.synth.bank import (BankParams, BankState, ImpactTable, TrackPool,
                                           VoiceTable)
    from mesheditor_tpu.synth.pallas_impact import render_block_impacts_pallas
    from mesheditor_tpu.synth.render import render_block_impl
    from mesheditor_tpu.types import ModalModes as JaxModalModes

    def scene(bank, imp):
        params = BankParams(**{f: jnp.asarray(bank[f], jnp.float32) for f in BANK_FIELDS},
                            sample_rate=bank["sample_rate"])
        state = BankState(jnp.asarray(bank["z_re"], jnp.float32),
                          jnp.asarray(bank["z_im"], jnp.float32))
        dt = {"active": bool, "obj": jnp.int32, "expos": jnp.int32, "age": jnp.int32,
              "total": jnp.int32}
        table = ImpactTable(**{f: jnp.asarray(imp[f], dt.get(f, jnp.float32))
                               for f in IMPACT_FIELDS})
        return params, state, table

    def scan(bank, imp, n):
        params, state, table = scene(bank, imp)
        s, i, _v, out = render_block_impl(params, state, table, VoiceTable.empty(2),
                                          TrackPool.empty(2, 128), n, click_gain=1.0)
        return s, i, out

    def pallas(bank, imp, n):
        return render_block_impacts_pallas(*scene(bank, imp), n, click_gain=1.0)

    return types.SimpleNamespace(scan=scan, pallas=pallas, ModalSynth=JaxModalSynth,
                                 ModalEvent=JaxModalEvent, ModalModes=JaxModalModes)


def make_scene(n_obj=4, k=32, n_imp=8, impacts_per_obj=2, seed=3):
    """tests/test_pallas_impact.py:make_scene, in numpy (bank dict, impact dict)."""
    rng = np.random.default_rng(seed)
    freqs = np.linspace(80, 4000, k)
    decay = np.power(1e-3, 1.0 / (0.4 * 48000.0))
    omega = 2 * np.pi * freqs / 48000.0
    bank = {
        "coeff_re": np.tile(decay * np.cos(omega), (n_obj, 1)),
        "coeff_im": np.tile(decay * np.sin(omega), (n_obj, 1)),
        "disp_scale": np.tile(1 / (2 * np.pi * freqs), (n_obj, 1)),
        "shapes": rng.standard_normal((n_obj, 2, k, 3)) * 0.01,
        "out_gain": rng.uniform(0.5, 1.5, n_obj), "sample_rate": 48000.0,
        "z_re": rng.standard_normal((n_obj, k)) * 1e-3,
        "z_im": rng.standard_normal((n_obj, k)) * 1e-3,
    }
    act = np.zeros(n_imp, bool)
    obj = np.zeros(n_imp, np.int32)
    count = 0
    for o in range(n_obj):
        for _ in range(impacts_per_obj):
            if count < n_imp:
                act[count] = True
                obj[count] = o
                count += 1
    imp = {
        "active": act, "obj": obj, "expos": np.arange(n_imp, dtype=np.int32) % 2,
        "j": rng.standard_normal((n_imp, 3)) * 0.05,
        "pulse_step": np.full(n_imp, 1 / 180.0), "gamma": np.full(n_imp, np.pi / 2 / 180.0),
        "accel_amp": rng.uniform(0, 0.01, n_imp),
        "age": np.arange(n_imp, dtype=np.int32) * 3, "total": np.full(n_imp, 180, np.int32),
    }
    return bank, imp


def make_wide_scene():
    """A (64, 256) bank, one strike per object plus a second on every 8th."""
    bank, imp = make_scene(n_obj=64, k=256, n_imp=72, impacts_per_obj=1, seed=5)
    imp["active"][64:] = True
    imp["obj"][64:] = np.arange(0, 64, 8)
    return bank, imp


SCENES = {"make_scene": make_scene, "wide_64x256": make_wide_scene}


def port_scene(bank, imp, device="cpu"):
    params, state = convert.bank(**{f: bank[f] for f in BANK_FIELDS},
                                 sample_rate=bank["sample_rate"], z_re=bank["z_re"],
                                 z_im=bank["z_im"], device=device)
    return params, state, convert.impact_table(device=device, **imp)


def slots(imp):
    live = imp["obj"][imp["active"]]
    return int(np.bincount(live).max()) if live.size else 0


# Port and reference round the float32 recurrence differently (the port: separately rounded
# multiply-adds; the reference: whatever XLA fuses), and each sits about 2e-6 x peak from
# the exact float64 recurrence after ~1,000 samples (measured on these scenes; see
# test_state_accuracy_against_float64). An absolute floor of 1e-9 holds only for short
# blocks of the small scene, so elsewhere the state's floor scales with its peak.
STATE_FLOOR = 5e-6


def assert_block_close(port, ref, what, atol=None):
    (s_t, i_t, out_t), (s_j, i_j, out_j) = port, ref
    out_j = np.asarray(out_j)
    peak = max(np.abs(out_j).max(), 1e-12)
    assert np.abs(out_t.numpy() - out_j).max() < 2e-5 * peak, what
    for a, b in ((s_t.z_re, s_j.z_re), (s_t.z_im, s_j.z_im)):
        b = np.asarray(b)
        tol = STATE_FLOOR * np.abs(b).max() if atol is None else atol
        assert np.allclose(a.numpy(), b, rtol=1e-4, atol=tol), what
    assert np.array_equal(i_t.active.numpy(), np.asarray(i_j.active)), what
    assert np.array_equal(i_t.age.numpy(), np.asarray(i_j.age)), what


def test_plain_matches_pallas_kernel_strict(ref):
    """The reference's own parity check (test_pallas_impact.py:67-69): make_scene, one
    256-sample chunk, state at rtol 1e-4 / atol 1e-9."""
    bank, imp = make_scene()
    port = impact.render_block_impacts(*port_scene(bank, imp), 256, 1.0, slots(imp))
    assert_block_close(port, ref.pallas(bank, imp, 256), "make_scene", atol=1e-9)


def test_state_accuracy_against_float64(scan_blocks):
    """Port and reference state against the exact recurrence (float64 from the same
    float32 inputs): the port is as accurate as the reference."""
    from mesheditor_tpu_torch.synth.render import _impact_force_curves, impact_gain_rows

    bank, imp = make_wide_scene()
    n = 512
    params, state, table = port_scene(bank, imp)
    r = slots(imp)
    s_t, _i, _o = impact.render_block_impacts(params, state, table, n, 1.0, r)
    force, _prev = _impact_force_curves(table, n)
    gain_rok, force_sro = impact._regroup(table, impact_gain_rows(params, table), force,
                                          params.coeff_re.shape[0], r)
    excite = (force_sro.double()[:, :, :, None] * gain_rok.double()[None]).sum(1)
    cr, ci = params.coeff_re.double(), params.coeff_im.double()
    zr, zi = state.z_re.double(), state.z_im.double()
    for t in range(n):
        zr, zi = zr * cr - zi * ci + excite[t], zr * ci + zi * cr
    s_j, _ij, _oj = scan_blocks["wide_64x256", n]
    peak = float(zr.abs().max())
    err_port = float((s_t.z_re.double() - zr).abs().max())
    err_ref = float((torch.tensor(np.asarray(s_j.z_re), dtype=torch.float64) - zr).abs().max())
    assert err_port < 0.5 * STATE_FLOOR * peak
    assert err_port < 2.0 * err_ref


@pytest.mark.parametrize("name", SCENES)
def test_plain_matches_pallas_kernel(ref, name):
    bank, imp = SCENES[name]()
    port = impact.render_block_impacts(*port_scene(bank, imp), 256, 1.0, slots(imp))
    assert_block_close(port, ref.pallas(bank, imp, 256), name)


@pytest.fixture(scope="module")
def scan_blocks(ref):
    """The reference's scan render of each scene at an off-chunk sample count."""
    return {(name, n): ref.scan(*SCENES[name](), n)
            for name, n in (("make_scene", 300), ("wide_64x256", 512))}


@pytest.mark.parametrize("name, n_samples", [("make_scene", 300), ("wide_64x256", 512)])
def test_plain_matches_scan_path(scan_blocks, name, n_samples):
    bank, imp = SCENES[name]()
    port = impact.render_block_impacts(*port_scene(bank, imp), n_samples, 1.0, slots(imp))
    assert_block_close(port, scan_blocks[name, n_samples], f"{name} S={n_samples}")


def test_more_impacts_per_object_than_the_tpu_kernel_took(ref):
    """Six live impacts on one object (the reference's Pallas path took four): the port
    takes any count, and matches the reference's scan path."""
    bank, imp = make_scene(n_obj=2, k=16, n_imp=8, impacts_per_obj=6)
    assert slots(imp) == 6
    port = impact.render_block_impacts(*port_scene(bank, imp), 500, 1.0, 6)
    assert_block_close(port, ref.scan(bank, imp, 500), "6 per object")


@pytest.mark.parametrize("n_samples", [1, 256, 300])
@pytest.mark.parametrize("name", SCENES)
def test_block_boundary_invariance_is_bit_exact(name, n_samples):
    bank, imp = SCENES[name]()
    params, state, table = port_scene(bank, imp)
    r = slots(imp)
    s1, i1, o1 = impact.render_block_impacts(params, state, table, n_samples, 1.0, r)
    s2, i2, o2 = impact.render_block_impacts(params, s1, i1, n_samples, 1.0, r)
    s12, i12, o12 = impact.render_block_impacts(params, state, table, 2 * n_samples, 1.0, r)
    assert torch.equal(o12, torch.cat([o1, o2]))
    assert torch.equal(s12.z_re, s2.z_re) and torch.equal(s12.z_im, s2.z_im)
    assert torch.equal(i12.age, i2.age) and torch.equal(i12.active, i2.active)


def test_regroup_layout():
    bank, imp = make_scene(n_obj=3, k=8, n_imp=6, impacts_per_obj=2)
    imp["active"][3] = False  # object 1 keeps one impact
    params, _state, table = port_scene(bank, imp)
    from mesheditor_tpu_torch.synth.render import _impact_force_curves, impact_gain_rows

    force, _prev = _impact_force_curves(table, 10)
    gains = impact_gain_rows(params, table)
    gain_rok, force_sro = impact._regroup(table, gains, force, 3, 2)
    assert gain_rok.shape == (2, 3, 8) and force_sro.shape == (10, 2, 3)
    # object o's r-th live impact (table order) sits in slot (r, o)
    expect = {(0, 0): 0, (1, 0): 1, (0, 1): 2, (0, 2): 4, (1, 2): 5}
    for (r, o), i in expect.items():
        assert torch.equal(gain_rok[r, o], gains[i])
        assert torch.equal(force_sro[:, r, o], force[i])
    assert gain_rok[1, 1].abs().max() == 0 and force_sro[:, 1, 1].abs().max() == 0


def test_engine_matches_reference_engine(ref):
    """The port's ModalSynth against the reference's (scan path on the CPU): strikes,
    a silence, a gain change, odd block sizes."""
    rng = np.random.default_rng(7)
    freqs, t60s = np.linspace(150, 6000, 24), np.linspace(0.8, 0.1, 24)
    shapes = (rng.standard_normal((3, 24, 3)) * 0.02).astype(np.float32)
    port = ModalSynth([ModalModes(freqs, t60s, shapes)] * 3, gains=[1.0, 0.5, 2.0],
                      max_impacts=8, device="cpu")
    jax_synth = ref.ModalSynth([ref.ModalModes(freqs, t60s, shapes)] * 3,
                               gains=[1.0, 0.5, 2.0], max_impacts=8, max_voices=2)
    script = [
        (300, [("strike", 0, 1, (0.3, 0.1, 0.0), 0.003), ("strike", 2, 0, (0, 0.2, 0.1), 0.002)]),
        (512, [("strike", 0, 2, (0.1, 0.1, 0.1), 0.001), ("strike", 1, 1, (0, 0, 0.5), 0.004)]),
        (700, [("silence", 2)]),
        (333, [("gain", 1, 3.0), ("strike", 2, 2, (0.2, 0, 0), 0.002)]),
    ]
    for n, events in script:
        for ev in events:
            for synth in (port, jax_synth):
                if ev[0] == "strike":
                    synth.strike(ev[1], ev[2], ev[3], ev[4], accel_amp=0.001)
                elif ev[0] == "silence":
                    synth.silence(ev[1])
                else:
                    synth.set_gain(ev[1], ev[2])
        a = port.render(n).numpy()
        b = np.asarray(jax_synth.render(n))
        assert np.abs(a - b).max() < 2e-5 * max(np.abs(b).max(), 1e-12)
    assert port.active_impacts == jax_synth.active_impacts


def test_render_seconds_fused_equals_blocks():
    modes = ModalModes(np.linspace(200, 3000, 16), np.full(16, 0.4),
                       np.full((2, 16, 3), 0.01, np.float32))

    def run(fuse):
        synth = ModalSynth([modes] * 2, gains=[1.0, 1.0], device="cpu")
        synth.enqueue(ModalEvent("impact", obj=1, expos=1, j=(1, 0, 0), pulse_step=1 / 100,
                                 pulse_gamma=np.pi / 200, accel_amp=0.01))
        return synth.render_seconds(0.4, 512, fuse=fuse)

    assert np.array_equal(run(True), run(False))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    bank, imp = SCENES[name]()
    r = slots(imp)
    before = impact.LAUNCHES
    kern = impact.render_block_impacts(*port_scene(bank, imp, "cuda"), 1000, 1.0, r)
    assert impact.LAUNCHES == before + 1
    plain = impact.render_block_impacts(*port_scene(bank, imp, "cpu"), 1000, 1.0, r)
    s_k, i_k, o_k = kern[0], kern[1], kern[2].cpu()
    peak = plain[2].abs().max()
    assert (o_k - plain[2]).abs().max() < 2e-5 * peak
    assert torch.allclose(s_k.z_re.cpu(), plain[0].z_re, rtol=1e-4, atol=1e-9)
    assert torch.allclose(s_k.z_im.cpu(), plain[0].z_im, rtol=1e-4, atol=1e-9)
    assert torch.equal(i_k.age.cpu(), plain[1].age)
    assert torch.equal(i_k.active.cpu(), plain[1].active)
    # Same card tensors through both recurrences: separately rounded float32 multiply-adds
    # on both sides, so the state is bit-identical and only the mix's summation order
    # differs.
    from mesheditor_tpu_torch.synth.render import _impact_force_curves, impact_gain_rows

    params, state, table = port_scene(bank, imp, "cuda")
    force, _prev = _impact_force_curves(table, 1000)
    gain_rok, force_sro = impact._regroup(table, impact_gain_rows(params, table), force,
                                          params.coeff_re.shape[0], r)
    args = (params.coeff_re, params.coeff_im, params.out_gain, gain_rok, force_sro,
            state.z_re, state.z_im)
    mix_k, zr_k, zi_k = impact.resonate(*args)
    mix_p, zr_p, zi_p = impact._resonate_plain(*args)
    assert torch.equal(zr_k, zr_p) and torch.equal(zi_k, zi_p)
    assert (mix_k - mix_p).abs().max() < 2e-5 * mix_p.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples", [1, 33, 1000])
@pytest.mark.parametrize("name", SCENES)
def test_kernel_state_is_bit_identical_on_card(name, n_samples):
    """The kernel's state equals the plain version's bit for bit on the same card tensors;
    2S samples equal S then S."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mesheditor_tpu_torch.synth.render import _impact_force_curves, impact_gain_rows

    bank, imp = SCENES[name]()
    params, state, table = port_scene(bank, imp, "cuda")
    force, _prev = _impact_force_curves(table, 2 * n_samples)
    gain_rok, force_sro = impact._regroup(table, impact_gain_rows(params, table), force,
                                          params.coeff_re.shape[0], slots(imp))
    head = force_sro[:n_samples].contiguous()
    args = (params.coeff_re, params.coeff_im, params.out_gain, gain_rok, head, state.z_re,
            state.z_im)

    def run(*a):
        launch, out = impact._bind(*a)
        launch()
        return out

    mix_k, zr_k, zi_k = run(*args)
    mix_p, zr_p, zi_p = impact._resonate_plain(*args)
    assert torch.equal(zr_k, zr_p) and torch.equal(zi_k, zi_p)
    assert (mix_k - mix_p).abs().max() <= 2e-5 * mix_p.abs().max()
    mix_12, zr_12, zi_12 = run(*args[:4], force_sro, *args[5:])
    mix_2, zr_2, zi_2 = run(*args[:4], force_sro[n_samples:].contiguous(), zr_k, zi_k)
    assert torch.equal(mix_12, torch.cat([mix_k, mix_2]))
    assert torch.equal(zr_12, zr_2) and torch.equal(zi_12, zi_2)
