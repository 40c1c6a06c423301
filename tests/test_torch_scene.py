"""The scene-in / audio-out path of the port against the JAX package: the registry and its
components (copies), SceneAudio's reconcile cycle, PhysicsWorld (a copy: bit for bit) and
simulate_scene.

One reference Registry is built from a seed-free scene and carried into the port with
`convert.registry`, so both packages reconcile the same entities. Audio is compared with
both packages loading the SAME stored models (the reference solves, the port finds every
model in the store): two independent solves flip eigenvector signs, which changes the
samples but not the model. The tolerance is the one the sustained tests use, 5e-5 x peak."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
from mesheditor_tpu.mesh import cuboid_surface, icosphere_surface
from mesheditor_tpu.physics import scene_build as ref_scene_build
from mesheditor_tpu.scene import audio_sync as ref_sync
from mesheditor_tpu.scene import components as rc
from mesheditor_tpu.scene.registry import Registry as RefRegistry
from mesheditor_tpu.solve.postprocess import rescale_modes as ref_rescale_modes
from mesheditor_tpu.types import SolverConfig as RefSolverConfig

from mesheditor_tpu_torch import convert
from mesheditor_tpu_torch.physics import PhysicsWorld, scene_build
from mesheditor_tpu_torch.scene import audio_sync
from mesheditor_tpu_torch.scene import components as pc
from mesheditor_tpu_torch.solve import lobpcg
from mesheditor_tpu_torch.synth import coupled, engine, impact

HOST_PATH_RTOL = 5e-8  # both packages answer these small pencils by host shift-invert
# ModalModes stores float32: two float64 answers inside HOST_PATH_RTOL may round to
# neighbouring float32 values, one spacing (at most 2**-23 relative) apart.
STORED_RTOL = HOST_PATH_RTOL + 2.0 ** -23
SUSTAINED_TOL = 5e-5  # x peak: tests/test_torch_sustained.py's engine-against-engine limit


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _glass():
    return rc.AcousticMaterialRef(name="Glass", density=2600.0, young_modulus=6.2e10,
                                  poisson_ratio=0.20, alpha=1.0, beta=1e-7)


def make_scene():
    """The reference's reconcile-test scene: one 3 cm glass icosphere."""
    reg = RefRegistry()
    e = reg.create()
    pts, tris = icosphere_surface(1)
    reg.emplace(e, rc.MeshSurface(positions=pts * 0.03, triangles=tris))
    reg.emplace(e, _glass())
    reg.emplace(e, rc.SolveSettingsComponent(num_modes=6, num_vertices=4, max_mode_freq=2e5))
    return reg, e


def carry(ref_reg):
    """The port's Registry with the reference registry's entities and components."""
    return convert.registry({e: [ref_reg.get(e, t) for t in ref_reg.component_types()
                                 if ref_reg.has(e, t)] for e in ref_reg.entities()})


def reports_equal(a, b):
    fields = ("solved", "rescaled", "loaded", "removed", "up_to_date")
    return all(getattr(a, f) == getattr(b, f) for f in fields)


def test_convert_registry_keeps_ids_components_and_values():
    ref, e = make_scene()
    gone = ref.create()
    keep = ref.create()
    ref.destroy(gone)
    ref.emplace(keep, rc.RigidBodyComponent(shape_kind="plane"))
    ref.emplace(e, rc.Transform(translation=np.array([0.0, 0.2, 0.0])))
    reg = carry(ref)
    assert reg.entities() == ref.entities() == [e, keep]
    assert reg.create() == ref.create()  # the id counters agree too
    assert {t.__name__ for t in reg.component_types()} == \
        {t.__name__ for t in ref.component_types()}
    surf, rsurf = reg.get(e, pc.MeshSurface), ref.get(e, rc.MeshSurface)
    np.testing.assert_array_equal(surf.positions, rsurf.positions)
    assert surf.positions is not rsurf.positions
    assert reg.get(keep, pc.RigidBodyComponent).shape_kind == "plane"
    assert not reg.drain_events()  # carrying a scene over is not an edit


def test_solve_rescale_reload_cycle_follows_reference(tmp_path):
    ref, e = make_scene()
    reg = carry(ref)
    ra = ref_sync.SceneAudio(ref, tmp_path / "ref", tet_resolution=6)
    sa = audio_sync.SceneAudio(reg, tmp_path / "port", tet_resolution=6, device="cpu")

    def both():
        a, b = sa.reconcile(), ra.reconcile()
        assert reports_equal(a, b), (a, b)
        return a

    def freqs_agree():
        f, rf = sa._live[e].modes.freqs, np.asarray(ra._live[e].modes.freqs)
        assert f.shape == rf.shape and f.size > 0
        assert np.abs(f / rf - 1).max() < STORED_RTOL
        lam, rlam = sa._live[e].summary.eigenvalues, ra._live[e].summary.eigenvalues
        assert np.abs(np.sqrt(lam[6:] / np.asarray(rlam)[6:]) - 1).max() < HOST_PATH_RTOL

    # 1. The first reconcile solves and wires the bank.
    assert both().solved == [e]
    comp, rcomp = reg.get(e, pc.ModalModel), ref.get(e, rc.ModalModel)
    assert comp.inputs_hash == rcomp.inputs_hash and comp.path
    assert reg.get(e, pc.ExciteState).bank_slot == 0
    freqs_agree()
    base = sa._live[e].modes.freqs.copy()
    # 2. No edit: nothing happens.
    assert both().up_to_date == [e]
    # 3. Density x2 is not staleness: an exact rescale and no eigensolve.
    reg.get(e, pc.AcousticMaterialRef).density = 5200.0
    ref.get(e, rc.AcousticMaterialRef).density = 5200.0
    solves = lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES
    summary, modes, mat = ra._live[e].summary, ra._live[e].modes, ra._material(e)
    assert both().rescaled == [e]
    assert lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES == solves
    freqs_agree()
    np.testing.assert_allclose(sa._live[e].modes.freqs, base / np.sqrt(2.0), rtol=1e-3)
    # The port's rescale of the port's summary against the reference's rescale_modes of the
    # reference's: the same closed form on eigenvalues that agree at the solve tolerance.
    expect = ref_rescale_modes(summary, modes, mat, RefSolverConfig(
        min_mode_freq=20.0, max_mode_freq=2e5, num_modes=6))
    assert np.abs(sa._live[e].modes.freqs / np.asarray(expect.freqs) - 1).max() < STORED_RTOL
    assert np.abs(sa._live[e].modes.t60s / np.asarray(expect.t60s) - 1).max() < STORED_RTOL
    # 4. A Poisson edit is staleness: re-solve.
    reg.get(e, pc.AcousticMaterialRef).poisson_ratio = 0.30
    ref.get(e, rc.AcousticMaterialRef).poisson_ratio = 0.30
    assert both().solved == [e]
    freqs_agree()
    # 5. A geometry edit (scale) is staleness too.
    reg.emplace(e, pc.Transform(scale=np.array([2.0, 2.0, 2.0])))
    ref.emplace(e, rc.Transform(scale=np.array([2.0, 2.0, 2.0])))
    assert both().solved == [e]
    freqs_agree()
    # 6. Fresh coordinators over the same registries trust the stored fingerprint.
    sb = audio_sync.SceneAudio(reg, tmp_path / "port", tet_resolution=6, device="cpu")
    rb = ref_sync.SceneAudio(ref, tmp_path / "ref", tet_resolution=6)
    solves = lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES
    a, b = sb.reconcile(), rb.reconcile()
    assert reports_equal(a, b) and a.loaded == [e]
    assert lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES == solves
    np.testing.assert_array_equal(sb._live[e].modes.freqs, sa._live[e].modes.freqs)


def test_port_loads_the_models_the_reference_stored(tmp_path):
    """A scene the reference solved and saved opens in the port without a solve."""
    ref, e = make_scene()
    ref_sync.SceneAudio(ref, tmp_path, tet_resolution=6).reconcile()
    reg = carry(ref)  # the ModalModel component carries the stored path and fingerprint
    sa = audio_sync.SceneAudio(reg, tmp_path, tet_resolution=6, device="cpu")
    solves = lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES
    assert sa.reconcile().loaded == [e]
    assert lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES == solves
    assert sa.synth is not None and sa.synth.device.type == "cpu"


def _per_mode_scale(ref, e, store, direction, n_samples) -> float:
    """max_t sum_k |output of mode k alone|: the render's scale before its modes mix.

    A mode shape's sign is arbitrary (ARPACK's random start, which moves with every solve
    the process has made), and the 3 cm shell's six modes lie within 0.1% of each other, so
    the sign pattern decides how far they cancel: the mixed peak of one stored model came
    out between 0.226 and 81.7 across processes, while the float32 difference between the
    packages stayed near 1e-4. This scale is the same whatever signs the solve gave."""
    sa = audio_sync.SceneAudio(carry(ref), store, sample_rate=96_000.0, tet_resolution=6,
                               device="cpu")
    sa.reconcile()
    shapes = sa.synth.params.shapes
    total = np.zeros(n_samples)
    for k in range(shapes.shape[2]):
        one = audio_sync.SceneAudio(carry(ref), store, sample_rate=96_000.0,
                                    tet_resolution=6, device="cpu")
        assert one.reconcile().loaded == [e]
        keep = torch.zeros(shapes.shape[2])
        keep[k] = 1.0
        one.synth.params.shapes = shapes * keep[None, None, :, None]
        one.strike(e, 0, direction)
        total += np.abs(one.render_with_samples(n_samples))
    return float(total.max())


def _strike_and_tuning(tmp_path):
    ref, e = make_scene()
    ref.emplace(e, rc.ModalGainComponent(value=2.0))
    # The 3 cm glass shell rings above 30 kHz: render at 96 kHz so the modes clear the
    # Nyquist mute. The port loads what the reference solved, so the samples compare.
    ra = ref_sync.SceneAudio(ref, tmp_path, sample_rate=96_000.0, tet_resolution=6)
    ra.reconcile()
    reg = carry(ref)
    sa = audio_sync.SceneAudio(reg, tmp_path, sample_rate=96_000.0, tet_resolution=6,
                               device="cpu")
    sa.reconcile()
    np.testing.assert_array_equal(sa.synth.params.out_gain.numpy(),
                                  np.asarray(ra.synth.params.out_gain))
    direction = (0.02, 0.05, 0.01)
    sa.strike(e, 0, direction)
    ra.strike(e, 0, direction)
    out, rout = sa.render_with_samples(1024), ra.render_with_samples(1024)
    assert isinstance(out, np.ndarray) and np.isfinite(out).all() and np.abs(out).max() > 0
    scale = _per_mode_scale(ref, e, tmp_path, direction, 1024)
    assert scale >= np.abs(rout).max()
    assert np.abs(out - rout).max() < SUSTAINED_TOL * scale
    # Tuning shifts the fundamental without a re-solve, in both banks alike.
    f1 = float(sa._live[e].modes.freqs[0])
    reg.emplace(e, pc.ModalTuningComponent(fundamental_freq=f1 / 2, t60_scale=1.0))
    ref.emplace(e, rc.ModalTuningComponent(fundamental_freq=f1 / 2, t60_scale=1.0))
    a, b = sa.reconcile(), ra.reconcile()
    assert reports_equal(a, b) and not a.solved and not a.rescaled
    np.testing.assert_allclose(sa.synth.params.coeff_re.numpy(),
                               np.asarray(ra.synth.params.coeff_re), rtol=0, atol=1e-6)
    # A strike on an entity the bank does not hold is ignored.
    sa.strike(e + 17, 0, direction)
    assert not sa.synth._pending_events


def test_strike_and_tuning_follow_reference(tmp_path):
    _strike_and_tuning(tmp_path)


def test_strike_and_tuning_follow_reference_after_prior_arpack_solves(tmp_path):
    """The same after other shift-invert solves in this process: each one moves ARPACK's
    random start, and with it the signs of the next solve's modes."""
    rng = np.random.default_rng(20261016)
    for n in (120, 160, 200):
        a = scipy.sparse.random(n, n, density=0.05, random_state=rng)
        scipy.sparse.linalg.eigsh(a + a.T + 10.0 * scipy.sparse.eye(n), k=3, sigma=0.0)
    _strike_and_tuning(tmp_path)


def test_entity_removal_shrinks_bank(tmp_path):
    ref, e = make_scene()
    ref_sync.SceneAudio(ref, tmp_path, tet_resolution=6).reconcile()
    reg = carry(ref)
    sa = audio_sync.SceneAudio(reg, tmp_path, tet_resolution=6, device="cpu")
    sa.reconcile()
    assert sa.synth is not None and sa.slot_of(e) == 0
    reg.remove(e, pc.MeshSurface)
    assert sa.reconcile().removed == [e]
    assert sa.synth is None and sa.slot_of(e) == -1
    assert np.array_equal(sa.render_with_samples(64), np.zeros(64, np.float32))


def _physics_scene(mod):
    """A seeded pile: spheres, boxes and a capsule over a plane, some moving sideways."""
    rng = np.random.default_rng(20261016)
    reg = (RefRegistry if mod is rc else audio_sync.Registry)()
    floor = reg.create()
    reg.emplace(floor, mod.RigidBodyComponent(shape_kind="plane"))
    for i in range(4):
        e = reg.create()
        kind = ("sphere", "box", "capsule")[i % 3]
        reg.emplace(e, mod.Transform(translation=np.array(
            [0.25 * i - 0.6, 0.15 + 0.1 * rng.random(), 0.1 * rng.standard_normal()])))
        reg.emplace(e, mod.RigidBodyComponent(
            shape_kind=kind, radius=0.04, half_height=0.05,
            half_extents=np.array([0.05, 0.03, 0.04]), is_dynamic=True, mass=0.4,
            linear_velocity=np.array([1.2 * rng.standard_normal(), 0.0, 0.3]),
            angular_velocity=rng.standard_normal(3)))
    return reg


def _assert_same_fields(a, b, step):
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for name in names:
        assert np.array_equal(getattr(a, name), getattr(b, name)), (step, name)


def test_physics_world_steps_bit_for_bit():
    world, handles = scene_build.build_world(_physics_scene(pc))
    rworld, rhandles = ref_scene_build.build_world(_physics_scene(rc))
    assert isinstance(world, PhysicsWorld) and handles == rhandles
    n_impacts = n_sustained = 0
    for step in range(150):
        world.step()
        rworld.step()
        assert len(world.impacts) == len(rworld.impacts), step
        for a, b in zip(world.impacts, rworld.impacts):
            _assert_same_fields(a, b, step)
        assert world.sustained.keys() == rworld.sustained.keys(), step
        for key, sc in world.sustained.items():
            _assert_same_fields(sc, rworld.sustained[key], step)
        n_impacts += len(world.impacts)
        n_sustained += len(world.sustained)
    assert n_impacts > 0 and n_sustained > 0
    for h in handles.values():
        a, b = world.bodies[h], rworld.bodies[h]
        for field in ("pos", "quat", "vel", "ang"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def _drop_scene():
    """A glass ball dropped onto a plane beside a glass block thrown along it: the ball
    strikes and rests, the block strikes and slides (a sustained voice)."""
    ref, ball = make_scene()
    ref.emplace(ball, rc.Transform(translation=np.array([0.0, 0.2, 0.0])))
    ref.emplace(ball, rc.RigidBodyComponent(shape_kind="sphere", radius=0.03,
                                            is_dynamic=True, mass=0.3))
    block = ref.create()
    pts, tris = cuboid_surface((0.06, 0.04, 0.05))
    ref.emplace(block, rc.MeshSurface(positions=pts, triangles=tris))
    ref.emplace(block, _glass())
    ref.emplace(block, rc.SolveSettingsComponent(num_modes=6, num_vertices=4,
                                                 max_mode_freq=2e5))
    ref.emplace(block, rc.Transform(translation=np.array([0.3, 0.05, 0.0])))
    ref.emplace(block, rc.RigidBodyComponent(
        shape_kind="box", half_extents=np.array([0.03, 0.02, 0.025]), is_dynamic=True,
        mass=0.3, linear_velocity=np.array([1.5, 0.0, 0.0])))
    floor = ref.create()
    ref.emplace(floor, rc.RigidBodyComponent(shape_kind="plane"))
    return ref, ball, block


def test_simulate_scene_matches_reference(tmp_path, monkeypatch):
    ref, ball, block = _drop_scene()
    ref_sync.SceneAudio(ref, tmp_path, tet_resolution=6).reconcile()  # solve once, store
    reg = carry(ref)
    blocks = {"coupled": 0, "impacts": 0}
    for name, key in (("render_block_coupled", "coupled"), ("render_block_impacts", "impacts")):
        def counted(*args, _inner=getattr(engine, name), _key=key, **kwargs):
            blocks[_key] += 1
            return _inner(*args, **kwargs)
        monkeypatch.setattr(engine, name, counted)
    launches = (impact.LAUNCHES, coupled.LAUNCHES)
    solves = lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES
    kw = dict(seconds=0.4, sample_rate=96_000.0, tet_resolution=6)
    audio = audio_sync.simulate_scene(reg, tmp_path, device="cpu", **kw)
    assert lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES == solves  # every model was loaded
    assert (impact.LAUNCHES, coupled.LAUNCHES) == launches  # the CPU launches no kernel
    assert blocks["coupled"] > 0 and blocks["impacts"] > 0  # a voice lived, and ended
    expect = ref_sync.simulate_scene(ref, tmp_path, **kw)
    assert audio.shape == expect.shape == (75 * 512,) and audio.dtype == np.float32
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    assert np.abs(audio - expect).max() < SUSTAINED_TOL * np.abs(expect).max()
    # The impact comes after the free fall, not at t = 0, and the poses were written back.
    assert int(np.flatnonzero(np.abs(audio) > 0)[0]) > 0
    for e in (ball, block):
        t, rt = reg.get(e, pc.Transform), ref.get(e, rc.Transform)
        np.testing.assert_array_equal(t.translation, rt.translation)
        np.testing.assert_array_equal(t.rotation, rt.rotation)
    assert reg.get(block, pc.Transform).translation[0] > 0.35  # it slid


def test_drop_rings_and_rests(tmp_path):
    """The reference's own drop test on the port, solving for itself."""
    ref, ball, _block = _drop_scene()
    reg = carry(ref)
    solves = lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES
    audio = audio_sync.simulate_scene(reg, tmp_path / "modal", seconds=0.6,
                                      sample_rate=96_000.0, tet_resolution=6, device="cpu")
    assert lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES == solves + 2
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
    first = int(np.flatnonzero(np.abs(audio) > 0)[0])
    assert 0 < first
    assert abs(reg.get(ball, pc.Transform).translation[1] - 0.03) < 0.01  # rests at its radius
    assert reg.get(ball, pc.ModalModel).path  # the solve left its fingerprint on the entity


def test_simulate_scene_without_audible_entities_is_silent(tmp_path):
    reg = audio_sync.Registry()
    floor = reg.create()
    reg.emplace(floor, pc.RigidBodyComponent(shape_kind="plane"))
    mute = reg.create()
    reg.emplace(mute, pc.Transform(translation=np.array([0.0, 0.1, 0.0])))
    reg.emplace(mute, pc.RigidBodyComponent(shape_kind="sphere", radius=0.02, is_dynamic=True,
                                            mass=0.1))
    audio = audio_sync.simulate_scene(reg, tmp_path, seconds=0.05, device="cpu")
    assert audio.shape == (5 * 512,) and not audio.any()
    assert reg.get(mute, pc.Transform).translation[1] < 0.1  # physics ran all the same
