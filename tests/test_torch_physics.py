"""The reference's rigid-body cases (tests/test_physics.py) on the port's physics
(mesheditor_tpu_torch.physics): the world's free fall, bounces, determinism, resting
contact and pose baking, joints, mesh mass properties, edge contacts and the collision ->
audio bridge through the port's synth on the CPU. Its bodies coming to rest (a box, a mesh
solid, a sphere on mesh terrain, a mesh stack) are tests/test_torch_physics_rest.py, its
box tower tests/test_torch_physics_tower.py, and the shapes file's cases
(tests/test_physics_shapes.py) tests/test_torch_physics_shapes.py: each numpy step costs
tens of milliseconds, every world here is stepped twice, and the test runner gives each
file to one worker, so the heavy scenarios sit in files of their own.

Each scenario is built once per package by one function. The reference's property checks
are held on the port's world. Every world is stepped in lockstep with the reference's on
the same inputs, and the two are held bit for bit: each step's impact and sustained
reports, and every body's final pose and velocities. That holds while the port's
physics/world.py is a byte copy of the reference's. When the rewrite of `step()` (ROADMAP
Queue 2 item 1) changes the summation order, the lockstep comparison becomes a tolerance
and the property checks stay as they are.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
from mesheditor_tpu import materials as ref_materials
from mesheditor_tpu import mesh as ref_mesh
from mesheditor_tpu import types as ref_types
from mesheditor_tpu.physics import bridge as ref_bridge
from mesheditor_tpu.physics import mass_props as ref_mass_props
from mesheditor_tpu.physics import scene_build as ref_scene_build
from mesheditor_tpu.physics import types as ref_ptypes
from mesheditor_tpu.physics import world as ref_world
from mesheditor_tpu.scene import components as ref_components
from mesheditor_tpu.scene import derive as ref_derive
from mesheditor_tpu.scene import registry as ref_registry
from mesheditor_tpu.synth import contact as ref_contact

from mesheditor_tpu_torch import materials, mesh, types
from mesheditor_tpu_torch.physics import bridge, mass_props, scene_build, world
from mesheditor_tpu_torch.physics import types as ptypes
from mesheditor_tpu_torch.scene import components, derive, registry
from mesheditor_tpu_torch.synth import ModalSynth, contact


def package(mesh_mod, ptypes_mod, world_mod, mass_mod, bridge_mod, contact_mod, types_mod,
            materials_mod, components_mod, registry_mod, derive_mod, scene_build_mod):
    """One package's physics surface, under the names the scenario functions use."""
    return SimpleNamespace(
        mesh=mesh_mod, world=world_mod, PhysicsWorld=world_mod.PhysicsWorld,
        **{n: getattr(ptypes_mod, n) for n in (
            "PhysicsMaterial", "PhysicsMotion", "ShapeBox", "ShapePlane", "ShapeSphere",
            "ShapeMesh", "ShapeCapsule", "ShapeCylinder", "ShapeConvexHull")},
        mesh_mass_properties=mass_mod.mesh_mass_properties, bridge=bridge_mod,
        ContactDynamics=contact_mod.ContactDynamics,
        ModalSoundControls=types_mod.ModalSoundControls, ModalModes=types_mod.ModalModes,
        CERAMIC=materials_mod.CERAMIC, components=components_mod,
        Registry=registry_mod.Registry,
        install_default_pipeline=derive_mod.install_default_pipeline,
        build_world=scene_build_mod.build_world)


PORT = package(mesh, ptypes, world, mass_props, bridge, contact, types, materials,
               components, registry, derive, scene_build)
REF = package(ref_mesh, ref_ptypes, ref_world, ref_mass_props, ref_bridge, ref_contact,
              ref_types, ref_materials, ref_components, ref_registry, ref_derive,
              ref_scene_build)
BODY_FIELDS = ("pos", "quat", "vel", "ang", "inv_mass", "inv_inertia_local")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def same_fields(a, b, what):
    """Two report records (dataclasses) equal field by field, arrays bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(np.asarray(x), np.asarray(y)), (what, f.name, x, y)


def same_bodies(w, r, what="final"):
    assert w.bodies.keys() == r.bodies.keys(), what
    for h in w.bodies:
        for f in BODY_FIELDS:
            assert np.array_equal(getattr(w.bodies[h], f), getattr(r.bodies[h], f)), \
                (what, h, f)


def lockstep(port_world, ref_world_, steps, each=None):
    """Step both worlds `steps` times, holding each step's impacts and sustained contacts
    equal, then every body. `each(port_world, ref_world)` runs after every step (the
    callers' drains and probes)."""
    for step in range(steps):
        port_world.step()
        ref_world_.step()
        assert len(port_world.impacts) == len(ref_world_.impacts), step
        for a, b in zip(port_world.impacts, ref_world_.impacts):
            same_fields(a, b, step)
        assert port_world.sustained.keys() == ref_world_.sustained.keys(), step
        for key, sc in port_world.sustained.items():
            same_fields(sc, ref_world_.sustained[key], step)
        if each is not None:
            each(port_world, ref_world_)
    same_bodies(port_world, ref_world_)


def both(build, *args, **kw):
    """(port's, reference's) results of one scenario function."""
    return build(PORT, *args, **kw), build(REF, *args, **kw)


# ---- scenarios (each function takes a package namespace) ----


def drop_sphere(P, height=1.0, restitution=0.5):
    w = P.PhysicsWorld()
    w.add_body(P.ShapePlane(), static=True, material=P.PhysicsMaterial(restitution=restitution))
    s = w.add_body(P.ShapeSphere(0.1), position=(0, height, 0),
                   material=P.PhysicsMaterial(restitution=restitution), report_contacts=True)
    return w, s


def free_fall(P):
    w = P.PhysicsWorld()
    s = w.add_body(P.ShapeSphere(0.1), position=(0, 10, 0),
                   motion=P.PhysicsMotion(linear_damping=0.0))
    return w, s


def pendulum(P):
    w = P.PhysicsWorld()
    anchor = w.add_body(P.ShapeSphere(0.01), position=(0, 1, 0), static=True)
    bob = w.add_body(P.ShapeSphere(0.05), position=(0.5, 1, 0),
                     motion=P.PhysicsMotion(mass=1.0))
    w.add_point_joint(anchor, bob, (0, 1, 0))
    return w, bob


def dumbbell(P):
    w = P.PhysicsWorld(gravity=(0, 0, 0))
    a = w.add_body(P.ShapeSphere(0.05), position=(0, 0, 0), motion=P.PhysicsMotion(mass=1.0))
    b = w.add_body(P.ShapeSphere(0.05), position=(0.4, 0, 0), motion=P.PhysicsMotion(mass=1.0))
    w.add_distance_joint(a, b, (0, 0, 0), (0.4, 0, 0))
    w.bodies[a].vel = np.array([0.0, 0.5, 0.0])
    w.bodies[b].vel = np.array([0.0, -0.5, 0.0])
    return w, a, b


def jointed_on_floor(P):
    w = P.PhysicsWorld()
    w.add_body(P.ShapePlane(), static=True)
    anchor = w.add_body(P.ShapeSphere(0.01), position=(0, 0.3, 0), static=True)
    bob = w.add_body(P.ShapeSphere(0.1), position=(0, 0.1, 0), motion=P.PhysicsMotion(mass=1.0))
    w.add_distance_joint(anchor, bob, (0, 0.3, 0), (0, 0.1, 0))
    return w, bob


def diamond_quat(axis):
    """45 degrees about `axis` (0 = x, 2 = z): a box's cross-section becomes a diamond, so
    it touches on an edge, never a face or a corner."""
    h = np.cos(np.pi / 8), np.sin(np.pi / 8)
    q = [h[0], 0.0, 0.0, 0.0]
    q[1 + axis] = h[1]
    return tuple(q)


DIAG = 0.05 * np.sqrt(2.0)


def crossed_rods(P):
    w = P.PhysicsWorld()
    a = w.add_body(P.ShapeBox((0.5, 0.05, 0.05)), position=(0, 0, 0), quat=diamond_quat(0))
    b = w.add_body(P.ShapeBox((0.05, 0.05, 0.5)), position=(0, -2 * DIAG + 0.004, 0),
                   quat=diamond_quat(2))
    return w._pair_contacts(w.bodies[a], w.bodies[b])


def rod_on_rail(P, meshes):
    """A rod dropped across a static rail: two diamond boxes, or (meshes) a box-mesh rod
    across a diamond-prism hull whose vertices are only at its ends, so only edge-midpoint
    probes find the contact. Returns (world, rod)."""
    w = P.PhysicsWorld()
    if not meshes:
        w.add_body(P.ShapeBox((0.05, 0.05, 0.5)), position=(0, 0, 0), quat=diamond_quat(2),
                   static=True)
        return w, w.add_body(P.ShapeBox((0.5, 0.05, 0.05)), position=(0, 2 * DIAG + 0.01, 0),
                             quat=diamond_quat(0), motion=P.PhysicsMotion(mass=1.0),
                             report_contacts=True)
    wdt, length = 0.1, 0.6
    rail = np.array([[0, wdt, z] for z in (-length, length)]
                    + [[wdt, 0, z] for z in (-length, length)]
                    + [[0, -wdt, z] for z in (-length, length)]
                    + [[-wdt, 0, z] for z in (-length, length)])
    rpts, rtris = P.world._hull_mesh(rail)
    w.add_body(P.ShapeMesh(positions=rpts, triangles=rtris))  # static scenery
    cpts, ctris = P.mesh.cuboid_surface((0.5, 0.04, 0.04))
    return w, w.add_body(P.ShapeMesh(positions=cpts, triangles=ctris),
                         position=(0, wdt + 0.04 + 0.005, 0),
                         motion=P.PhysicsMotion(mass=0.5), report_contacts=True)


# ---- the world ----


def test_free_fall():
    (w, s), (r, _) = both(free_fall)
    lockstep(w, r, 240)  # 1 s
    b = w.bodies[s]
    # y = 10 - g/2 t^2 (semi-implicit Euler is slightly below)
    assert abs(b.pos[1] - (10 - 0.5 * 9.81)) < 0.05
    assert abs(b.vel[1] + 9.81) < 0.05


@pytest.mark.parametrize("check, steps", [("impact", 480), ("rebound", 960)])
def test_bounce(check, steps):
    """Dropped from 0.5 m at restitution 0.5: the first impact faces up at over 1.5 m/s;
    the rebound peaks at about e^2 h above the radius (a loose band)."""
    (w, s), (r, _) = both(drop_sphere, 0.5, 0.5)
    impacts, peak = [], [0.0]

    def watch(pw, _rw):
        impacts.extend(pw.impacts)
        if impacts:
            peak[0] = max(peak[0], pw.bodies[s].pos[1])

    lockstep(w, r, steps, watch)
    assert impacts, "no impact reported"
    if check == "impact":
        first = impacts[0]
        assert first.speed > 1.5  # sqrt(2*9.81*0.4) ~ 2.8
        assert first.impulse > 0
        assert abs(first.direction @ np.array([0, 1, 0])) > 0.99
    else:
        assert 0.1 < peak[0] < 0.35


def test_two_runs_are_identical():
    def run(P):
        w, _ = drop_sphere(P)
        w.add_body(P.ShapeSphere(0.08), position=(0.05, 1.5, 0), report_contacts=True)
        traj = []
        for _ in range(600):
            w.step()
            traj.append(np.concatenate([b.pos for b in w.bodies.values()]))
        return np.asarray(traj)

    port = run(PORT)
    assert np.array_equal(port, run(PORT))
    assert np.array_equal(port, run(REF))


def test_resting_contact_becomes_sustained():
    (w, s), (r, _) = both(drop_sphere, 0.15, 0.0)
    lockstep(w, r, 720)
    b = w.bodies[s]
    assert abs(b.pos[1] - 0.1) < 0.02  # resting on the plane at its radius
    assert w.sustained, "no sustained contact for a resting body"
    sc = next(iter(w.sustained.values()))
    mass = 1.0 / b.inv_mass
    assert abs(sc.normal_force - mass * 9.81) < 0.5 * mass * 9.81  # load ~ m g


def test_pose_baking():
    (w, s), (r, _) = both(drop_sphere)
    w.bake_through(100)
    r.bake_through(100)
    poses = w.sample_poses_at(50)
    assert poses is not None and s in poses
    w2, s2 = drop_sphere(PORT)
    w2.bake_through(60)
    assert np.array_equal(w2.sample_poses_at(50)[s2][0], poses[s][0])
    for got, want in zip(poses[s], r.sample_poses_at(50)[s]):
        assert np.array_equal(got, want)
    same_bodies(w, r)


# ---- joints ----


def test_point_joint_pendulum_keeps_its_length():
    """A bob ball-jointed to a static anchor swings down with its distance to the pivot
    held by the constraint."""
    (w, bob), (r, _) = both(pendulum)
    lengths = []
    lockstep(w, r, 960, lambda pw, _rw: lengths.append(
        np.linalg.norm(pw.bodies[bob].pos - np.array([0, 1, 0]))))
    lengths = np.array(lengths)
    assert abs(lengths.mean() - 0.5) < 0.005
    assert lengths.max() - lengths.min() < 0.01
    assert w.bodies[bob].pos[1] < 1.0  # it actually swung down


def test_distance_joint_dumbbell_keeps_separation_and_center():
    (w, a, b), (r, *_) = both(dumbbell)
    lockstep(w, r, 960)
    d = np.linalg.norm(w.bodies[a].pos - w.bodies[b].pos)
    com = 0.5 * (w.bodies[a].pos + w.bodies[b].pos)
    assert abs(d - 0.4) < 0.002
    assert np.linalg.norm(com - [0.2, 0, 0]) < 1e-9


def test_joint_and_contact_solve_together():
    (w, bob), (r, _) = both(jointed_on_floor)
    lockstep(w, r, 480)
    p = w.bodies[bob].pos
    assert np.isfinite(p).all()
    assert 0.05 < p[1] < 0.25


# ---- mesh bodies, stacks, edges ----


def test_mesh_mass_properties_of_a_box_are_exact():
    (m, com, inertia), want = both(
        lambda P: P.mesh_mass_properties(*P.mesh.cuboid_surface((0.1, 0.2, 0.3)), 1000.0))
    assert abs(m - 48.0) < 1e-9
    assert np.abs(com).max() < 1e-12
    expect = 48.0 / 3 * np.array([0.2**2 + 0.3**2, 0.1**2 + 0.3**2, 0.1**2 + 0.2**2])
    np.testing.assert_allclose(np.diag(inertia), expect, rtol=1e-12)
    assert np.abs(inertia - np.diag(np.diag(inertia))).max() < 1e-12
    for got, ref in zip((m, com, inertia), want):
        assert np.array_equal(got, ref)


def test_crossed_rods_touch_edge_on_edge():
    """Two diamond rods crossing like an X touch edge on edge at the origin, with no
    corner of either inside the other: the contact is found, vertical and shallow."""
    contacts, want = both(crossed_rods)
    assert contacts, "edge-edge crossing produced no contact"
    _, _, point, normal, depth = contacts[0]
    assert abs(normal[1]) > 0.9, normal
    assert 0 < depth < 0.02
    assert np.linalg.norm(point[[0, 2]]) < 0.02
    assert len(contacts) == len(want)
    for (a1, a2, *got), (b1, b2, *ref) in zip(contacts, want):
        assert (a1.handle, a2.handle) == (b1.handle, b2.handle)
        for x, y in zip(got, ref):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("meshes", [False, True], ids=["boxes", "meshes"])
def test_rod_rests_across_a_rail(meshes):
    """A rod dropped across a rail rests on it with a sustained contact: diamond boxes
    (edge against edge), and meshes with vertices only at their ends (edge midpoints)."""
    (w, rod), (r, _) = both(rod_on_rail, meshes)
    lockstep(w, r, 720)
    floor = 0.8 * 0.1 if meshes else 1.5 * DIAG
    assert w.bodies[rod].pos[1] > floor, f"the rod fell through: y={w.bodies[rod].pos[1]:.4f}"
    assert w.sustained, "the resting rod reports no sustained contact"


# ---- the collision -> audio bridge, through the port's synth on the CPU ----


def bridge_body(P):
    """test_render_properties.make_modes(32, 0.3) as the struck object, a ceramic body
    with a machined surface."""
    k, points = 32, 4
    freqs = 40.0 * np.arange(1, k + 1) * 1.031
    shapes = np.zeros((points, k, 3), np.float32)
    for p in range(points):
        a = np.arange(1, k + 1) * 0.37 + p
        shapes[p, :, 0] = np.sin(a) * 0.01
        shapes[p, :, 1] = np.cos(a * 1.7) * 0.01
        shapes[p, :, 2] = np.sin(a * 2.3) * 0.01
    positions = np.stack([np.arange(points) * 0.01, np.zeros(points), np.zeros(points)], -1)
    modes = P.ModalModes(freqs=freqs, t60s=0.3 / np.arange(1, k + 1), shapes=shapes,
                         positions=positions)
    dyn = P.ContactDynamics(mass=2.0, inverse_inertia=np.eye(3) * 5.0,
                            contact_arm=np.asarray(positions, dtype=np.float64))
    body = P.bridge.AudioBody(synth_obj=0, dynamics=dyn, material=P.CERAMIC.properties,
                              sample_positions=np.asarray(positions, dtype=np.float64),
                              surface=P.bridge.SURFACE_MACHINED, curvature=10.0)
    return modes, body


def test_collision_impact_makes_sound():
    modes, body = bridge_body(PORT)
    synth = ModalSynth([modes], gains=[1.0], device="cpu")
    (w, s), (r, _) = both(drop_sphere, 0.5)
    link = PORT.bridge.AudioContactBridge(synth, PORT.ModalSoundControls(
        min_contact_impulse=0.01))
    link.register(s, body)
    lockstep(w, r, 240, lambda pw, _rw: link.on_impacts(pw.impacts))
    audio = synth.render_seconds(0.2)
    assert np.isfinite(audio).all()
    assert np.abs(audio).max() > 0, "collision produced no sound"


def test_scrape_publishes_voices():
    """A sphere sliding along the floor resolves to a voice, and the synth renders it."""
    def sliding(P):
        w = P.PhysicsWorld()
        w.add_body(P.ShapePlane(), static=True, material=P.PhysicsMaterial(restitution=0.0))
        s = w.add_body(P.ShapeSphere(0.1), position=(0, 0.099, 0), report_contacts=True,
                       material=P.PhysicsMaterial(restitution=0.0))
        w.bodies[s].vel = np.array([1.0, 0.0, 0.0])
        return w, s

    modes, body = bridge_body(PORT)
    synth = ModalSynth([modes], gains=[1.0], device="cpu")
    (w, s), (r, _) = both(sliding)
    link = PORT.bridge.AudioContactBridge(synth, PORT.ModalSoundControls())
    link.register(s, body)
    published = []

    def publish(pw, _rw):
        voices = link.resolve_voices(pw.sustained)
        if voices:
            published.append(len(voices))
            synth.publish_voices(voices)
            synth.render(256)

    lockstep(w, r, 240, publish)
    assert published, "sliding contact never resolved to a voice"
    audio = synth.render(512).numpy()
    assert np.isfinite(audio).all()
