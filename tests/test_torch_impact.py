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
from mesheditor_tpu_torch.parallel.sharding import ObjectBlock
from mesheditor_tpu_torch.synth import ModalEvent, ModalSynth, coupled, impact, strikes
from mesheditor_tpu_torch.synth.render import (_impact_force_curves, finish_block, impact_click,
                                               impact_gain_rows)
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
    bank, imp = make_wide_scene()
    n = 512
    params, state, table = port_scene(bank, imp)
    r = slots(imp)
    s_t, _i, _o = impact.render_block_impacts(params, state, table, n, 1.0, r)
    force, _prev = _impact_force_curves(table, n)
    gain_rok, force_sro = strikes._regroup(table, impact_gain_rows(params, table), force,
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
    force, _prev = _impact_force_curves(table, 10)
    gains = impact_gain_rows(params, table)
    gain_rok, force_sro = strikes._regroup(table, gains, force, 3, 2)
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


def strike_scene(n_samples=512, seed=0, n_obj=6, k=16, capacity=128):
    """A 128-row impact table as the engine leaves it: ten live strikes among retired rows
    that keep stale values (three live on object 0, two on objects 2 and 5), one live row
    with a negative gamma and one whose pulse ends inside an n_samples block."""
    bank, imp = make_scene(n_obj=n_obj, k=k, n_imp=capacity, impacts_per_obj=0, seed=seed)
    rng = np.random.default_rng(seed + 100)
    pulse_step = rng.uniform(1 / 144, 1 / 24, capacity).astype(np.float32)
    total = np.ceil(1.0 / pulse_step.astype(np.float64)).astype(np.int32)
    live = rng.choice(capacity, 10, replace=False)
    imp.update(
        pulse_step=pulse_step, total=total,
        gamma=(rng.uniform(0.001, 0.01, capacity) * rng.choice([-1, 1], capacity)),
        accel_amp=rng.uniform(0, 0.01, capacity),
        age=rng.integers(0, 400, capacity).astype(np.int32),
        obj=rng.integers(0, n_obj, capacity).astype(np.int32),
        expos=rng.integers(0, 2, capacity).astype(np.int32),
    )
    imp["active"][live] = True
    imp["obj"][live] = rng.permutation([0, 0, 0, 1, 2, 2, 3, 4, 5, 5])
    imp["age"][live] = [rng.integers(0, t) for t in total[live]]
    imp["gamma"][live[0]] = -abs(imp["gamma"][live[0]])
    end = live[1]  # this pulse ends half way through the block
    imp["total"][end] = max(24, n_samples)
    imp["pulse_step"][end] = np.float32(1.0 / imp["total"][end])
    imp["age"][end] = imp["total"][end] - max(1, n_samples // 2)
    return bank, imp


def same_bits(a, b):
    """Equal bit for bit (torch.equal takes -0 for +0)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


@pytest.mark.parametrize("n_samples", [1, 33, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_click_over_the_active_rows_equals_the_table_loop(seed, n_samples):
    """The strike kernel's click contract on the plain chain: one thread a sample, summing
    over the active rows only, in table order, the forces formed from the sample's age
    (float32 products, the sine in float64), equals impact_click's loop over every row."""
    _bank, imp = strike_scene(n_samples, seed)
    table = convert.impact_table(**imp)
    force, prev = _impact_force_curves(table, n_samples)
    want = impact_click(table, force, prev, 1.3)
    live = imp["active"]
    assert (imp["gamma"][live] < 0).any()
    ends = live & (imp["age"] + n_samples > imp["total"])
    assert n_samples == 1 or (ends.any() and (force[ends, 0] != 0).all())

    f32 = np.float32
    amp_gain = f32(1.3)
    click = np.zeros(n_samples, f32)
    s = np.arange(n_samples)

    def pulse(i, a, live):
        step_pi = f32(f32(np.pi) * imp["pulse_step"][i])
        phase = (step_pi * a.astype(f32)).astype(f32)
        f = (f32(imp["gamma"][i]) * np.sin(phase.astype(np.float64)).astype(f32)).astype(f32)
        return np.where(live, f, f32(0))

    for i in np.flatnonzero(imp["active"]):
        age, total = int(imp["age"][i]), int(imp["total"][i])
        f = pulse(i, age + 1 + s, age + 1 + s <= total)
        fp = pulse(i, age + s, (age + s <= total) & ((s > 0) | (age >= 1)))
        amp = f32(f32(imp["accel_amp"][i]) * amp_gain)
        click = (click + (amp * (f - fp).astype(f32)).astype(f32)).astype(f32)
    assert same_bits(torch.from_numpy(click), want)


def object_range_rule(imp, lo, hi, n_slots, gains, force):
    """The strike kernel's slot rule, written out: an active row on an object in [lo, hi)
    ranks among the earlier such rows on its object, and rank r < n_slots of object o owns
    slot (r, o - lo), holding 0 + its gain row and 0 + its force curve."""
    gain_rok = torch.zeros(n_slots, hi - lo, gains.shape[1])
    force_sro = torch.zeros(force.shape[1], n_slots, hi - lo)
    seen = {}
    for i in range(len(imp["active"])):
        o = int(imp["obj"][i])
        if not (imp["active"][i] and lo <= o < hi):
            continue
        r = seen[o] = seen.get(o, -1) + 1
        if r < n_slots:
            gain_rok[r, o - lo] = 0.0 + gains[i]
            force_sro[:, r, o - lo] = 0.0 + force[i]
    return gain_rok, force_sro, max(seen.values(), default=-1) + 1


@pytest.mark.parametrize("lo, hi", [(0, 6), (0, 3), (2, 5), (5, 6)])
def test_regroup_of_local_impacts_is_the_object_range_rule(lo, hi):
    """_regroup on ObjectBlock.local_impacts(table), for every n_slots up to one past the
    live maximum, equals the object-range rule the strike kernel applies to the whole
    table; the wrapper's CPU route gives the same slots and the click of the whole table."""
    n = 40
    bank, imp = strike_scene(n)
    params, _state = convert.bank(**{f: bank[f][lo:hi] for f in BANK_FIELDS},
                                  sample_rate=bank["sample_rate"], z_re=bank["z_re"][lo:hi],
                                  z_im=bank["z_im"][lo:hi])
    table = convert.impact_table(**imp)
    shard = ObjectBlock(group=None, lo=lo, hi=hi, n_objects=6)
    here = shard.local_impacts(table)
    force, prev = _impact_force_curves(table, n)
    gains = impact_gain_rows(params, here)
    r_max = object_range_rule(imp, lo, hi, 0, gains, force)[2]
    assert r_max >= 1
    for n_slots in range(r_max + 2):
        want_g, want_f, _ = object_range_rule(imp, lo, hi, n_slots, gains, force)
        gain_rok, force_sro = strikes._regroup(here, gains, force, hi - lo, n_slots)
        assert same_bits(gain_rok, want_g) and same_bits(force_sro, want_f)
        g, f, click = strikes.strike_precompute(params, table, n, 1.0, n_slots, shard)
        assert same_bits(g, want_g) and same_bits(f, want_f)
        assert same_bits(click, impact_click(table, force, prev, 1.0))


def test_cpu_route_never_loads_the_kernels(monkeypatch):
    """Impact and coupled blocks on CPU tables take the plain chain: the kernel library is
    never loaded, and neither the launch count nor the play/strike_precompute counter
    moves."""
    from mesheditor_tpu_torch import _build, profile
    from test_torch_sustained import coupled_scene, port_coupled

    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")

    monkeypatch.setattr(_build, "load_kernels", refuse)
    monkeypatch.setattr(profile, "enabled", True)
    profile.reset()
    try:
        bank, imp = make_scene()
        impact.render_block_impacts(*port_scene(bank, imp), 64, 1.0, slots(imp))
        coupled.render_block_coupled(*port_coupled(coupled_scene()), 64, 1.0, 1.0, 1.0, 1)
        assert strikes.LAUNCHES == 0
        assert "play/strike_precompute" not in profile.counts()
    finally:
        profile.reset()


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

    params, state, table = port_scene(bank, imp, "cuda")
    force, _prev = _impact_force_curves(table, 1000)
    gain_rok, force_sro = strikes._regroup(table, impact_gain_rows(params, table), force,
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

    bank, imp = SCENES[name]()
    params, state, table = port_scene(bank, imp, "cuda")
    force, _prev = _impact_force_curves(table, 2 * n_samples)
    gain_rok, force_sro = strikes._regroup(table, impact_gain_rows(params, table), force,
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


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


STRIKE_TABLES = {"table_128": 128, "table_300": 300}  # strike_scene's capacities


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples", [1, 33, 512, 1000, 16384])
@pytest.mark.parametrize("name", [*SCENES, *STRIKE_TABLES])
def test_strike_kernel_matches_plain_chain_on_card(name, n_samples):
    """The strike kernel's gain rows, forces and click equal the plain chain's bit for bit
    on the same card tensors: every n_slots up to one past the live maximum (rows dropped),
    a negative gamma, a pulse that ends inside the block, a sharded object range, and a
    table longer than one CTA's pass over its rows."""
    _needs_card()
    if name in STRIKE_TABLES:
        bank, imp = strike_scene(n_samples, capacity=STRIKE_TABLES[name])
    else:
        bank, imp = SCENES[name]()
        imp = {f: np.array(v) for f, v in imp.items()}
        imp["gamma"][1] = -imp["gamma"][1]
        imp["total"][2] = max(24, n_samples)
        imp["pulse_step"][2] = 1.0 / imp["total"][2]
        imp["age"][2] = imp["total"][2] - max(1, n_samples // 2)
    n_obj = len(bank["out_gain"])
    table = convert.impact_table(device="cuda", **imp)
    for lo, hi in ((0, n_obj), (1, n_obj // 2 + 1)):
        params, _state = convert.bank(**{f: bank[f][lo:hi] for f in BANK_FIELDS},
                                      sample_rate=bank["sample_rate"],
                                      z_re=bank["z_re"][lo:hi], z_im=bank["z_im"][lo:hi],
                                      device="cuda")
        shard = None if (lo, hi) == (0, n_obj) else ObjectBlock(None, lo, hi, n_obj)
        for n_slots in range(slots(imp) + 2):
            launch, got = strikes._bind(params, table, n_samples, 1.3, n_slots, lo)
            launch()
            want = strikes._plain(params, table, n_samples, 1.3, n_slots, shard)
            for what, g, w in zip(("gain_rok", "force_sro", "click"), got, want):
                assert same_bits(g, w), f"{what}: objects [{lo}, {hi}), n_slots={n_slots}"


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples", [1, 256, 300, 512])
@pytest.mark.parametrize("name", SCENES)
def test_strike_kernel_click_is_block_boundary_invariant_on_card(name, n_samples):
    """The kernel's click over 2S samples equals S then S (the table advanced by
    finish_block between), bit for bit."""
    _needs_card()
    bank, imp = SCENES[name]()
    params, state, table = port_scene(bank, imp, "cuda")
    r = slots(imp)
    _g, _f, c1 = strikes.strike_precompute(params, table, n_samples, 1.0, r)
    _s, table2, _v = finish_block(params, table, state.z_re, state.z_im, n_samples)
    _g, _f, c2 = strikes.strike_precompute(params, table2, n_samples, 1.0, r)
    _g, _f, c12 = strikes.strike_precompute(params, table, 2 * n_samples, 1.0, r)
    assert same_bits(c12, torch.cat([c1, c2]))


@pytest.mark.cuda
def test_each_card_block_launches_the_strike_kernel_once(monkeypatch):
    """render_block_impacts and render_block_coupled on the card raise strikes.LAUNCHES by
    one a block, the resonator kernel's count by one as before, and the
    play/strike_precompute counter by one a block."""
    _needs_card()
    from mesheditor_tpu_torch import profile
    from test_torch_sustained import coupled_scene, port_coupled

    monkeypatch.setattr(profile, "enabled", True)
    profile.reset()
    try:
        bank, imp = make_scene()
        params, state, table = port_scene(bank, imp, "cuda")
        before = strikes.LAUNCHES, impact.LAUNCHES, coupled.LAUNCHES
        for _ in range(3):
            state, table, _out = impact.render_block_impacts(params, state, table, 512, 1.0,
                                                             slots(imp))
        assert (strikes.LAUNCHES, impact.LAUNCHES, coupled.LAUNCHES) == (
            before[0] + 3, before[1] + 3, before[2])
        params, state, table, voices, pool = port_coupled(coupled_scene(), "cuda")
        for _ in range(2):
            state, table, voices, _out = coupled.render_block_coupled(
                params, state, table, voices, pool, 256, 1.0, 1.0, 1.0, 1)
        assert (strikes.LAUNCHES, impact.LAUNCHES, coupled.LAUNCHES) == (
            before[0] + 5, before[1] + 3, before[2] + 2)
        torch.cuda.synchronize()
        assert profile.counts()["play/strike_precompute"] == 5
    finally:
        profile.reset()
