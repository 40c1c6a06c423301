"""The scene stepper (scene/audio_sync.py SceneSimulation): its blocks are simulate_scene's
audio bit for bit, a restart after a run replays the physics and the bridge of a fresh
stepper on the same registry, and under `profile.enabled` a block records the physics and
bridge spans and the world's counters."""

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch import profile
from mesheditor_tpu_torch.mesh import cuboid_surface, icosphere_surface
from mesheditor_tpu_torch.scene import components as c
from mesheditor_tpu_torch.scene.audio_sync import SceneAudio, SceneSimulation, simulate_scene
from mesheditor_tpu_torch.scene.registry import Registry

KW = dict(sample_rate=96_000.0, block_size=512, tet_resolution=6, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _profile_off():
    profile.enabled = False
    profile.reset()
    yield
    profile.enabled = False
    profile.reset()


def drop_scene():
    """A glass ball dropped onto a plane beside a glass block thrown along it: the ball
    strikes and rests, the block strikes and slides (a sustained voice)."""
    reg = Registry()
    glass = dict(name="Glass", density=2600.0, young_modulus=6.2e10, poisson_ratio=0.20,
                 alpha=1.0, beta=1e-7)
    settings = dict(num_modes=6, num_vertices=4, max_mode_freq=2e5)
    ball = reg.create()
    pts, tris = icosphere_surface(1)
    reg.emplace(ball, c.MeshSurface(positions=pts * 0.03, triangles=tris))
    reg.emplace(ball, c.AcousticMaterialRef(**glass))
    reg.emplace(ball, c.SolveSettingsComponent(**settings))
    reg.emplace(ball, c.Transform(translation=np.array([0.0, 0.2, 0.0])))
    reg.emplace(ball, c.RigidBodyComponent(shape_kind="sphere", radius=0.03, is_dynamic=True,
                                           mass=0.3))
    block = reg.create()
    pts, tris = cuboid_surface((0.06, 0.04, 0.05))
    reg.emplace(block, c.MeshSurface(positions=pts, triangles=tris))
    reg.emplace(block, c.AcousticMaterialRef(**glass))
    reg.emplace(block, c.SolveSettingsComponent(**settings))
    reg.emplace(block, c.Transform(translation=np.array([0.3, 0.05, 0.0])))
    reg.emplace(block, c.RigidBodyComponent(
        shape_kind="box", half_extents=np.array([0.03, 0.02, 0.025]), is_dynamic=True,
        mass=0.3, linear_velocity=np.array([1.5, 0.0, 0.0])))
    floor = reg.create()
    reg.emplace(floor, c.RigidBodyComponent(shape_kind="plane"))
    return reg


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The scene's two models, solved once."""
    path = tmp_path_factory.mktemp("scene_store")
    SceneAudio(drop_scene(), path, tet_resolution=6, device="cpu").reconcile()
    return path


def physics_of(sim) -> tuple:
    """The world's bodies, reports and the last published voices, as comparable values."""
    w = sim.world
    bodies = [(h, b.pos.tobytes(), b.quat.tobytes(), b.vel.tobytes(), b.ang.tobytes())
              for h, b in sorted(w.bodies.items())]
    impacts = [(m.body_a, m.body_b, m.point.tobytes(), m.impulse, m.speed) for m in w.impacts]
    sustained = [(k, s.point.tobytes(), s.normal_force, s.slip_speed)
                 for k, s in w.sustained.items()]
    return bodies, impacts, sustained, sim.voices


def test_the_stepper_blocks_are_simulate_scenes_audio(store):
    seconds = 0.3
    audio = simulate_scene(drop_scene(), store, seconds, **KW)
    sim = SceneSimulation(drop_scene(), store, **KW)
    blocks = [sim.block() for _ in range(int(np.ceil(seconds * KW["sample_rate"] / 512)))]
    stepped = torch.cat(blocks).numpy()
    assert stepped.shape == audio.shape and np.abs(audio).max() > 0
    assert np.array_equal(stepped, audio)


def test_a_restart_replays_a_fresh_stepper(store):
    reg = drop_scene()
    played = SceneSimulation(reg, store, **KW)
    voiced = 0
    for _ in range(30):
        played.block()
        voiced += bool(played.voices)
    assert voiced > 0
    # block() leaves the registry's poses and velocities as they were: both start there.
    played.restart()
    fresh = SceneSimulation(reg, store, **KW)
    assert fresh.audio.reconcile().up_to_date == sorted(fresh.audio._slots)  # nothing solved
    strikes = 0
    for i in range(30):
        a, b = played.block(), fresh.block()
        assert physics_of(played) == physics_of(fresh)
        strikes += len(played.world.impacts)
        if i == 0:  # the played stepper kept its bank, still ringing from before
            assert a.abs().max() > 0 and not b.any()
    assert strikes > 0


def test_a_block_records_the_physics_and_bridge_spans_and_counters(store):
    sim = SceneSimulation(drop_scene(), store, **KW)
    profile.enabled = True
    for _ in range(25):
        sim.block()
    names = [s.name for s in profile.records()]
    counts = profile.counts()
    assert names.count("play/block") == 25
    assert names.count("play/physics") == counts["physics/steps"] > 25
    assert "play/bridge" in names and counts["physics/contacts"] > 0
    parents = {s.parent.name if s.parent else None
               for s in profile.records() if s.name in ("play/physics", "play/bridge")}
    assert parents == {None}  # beside the engine's play/block, never inside it
    profile.enabled = False
    profile.reset()
    sim.block()
    assert profile.records() == [] and profile.counts() == {}
