"""The reference's shape and hinge cases (tests/test_physics_shapes.py) on the port's
physics: segment distances, convex hulls, capsules, cylinders, hulls, hinges with limits
and motors, the shapes through the port's glTF and scene_build. Every stepped world runs
in lockstep with the reference's and is held bit for bit (tests/test_torch_physics.py says
how, and what changes when `step()` is rewritten)."""

import numpy as np
import pytest

from mesheditor_tpu.io import gltf as ref_gltf
from mesheditor_tpu_torch.io.gltf import export_gltf, import_gltf
from test_torch_physics import PORT, REF, _one_thread, both, lockstep  # noqa: F401

CUBE = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float64)
LYING = np.array([np.cos(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4)])  # local y to world x


@pytest.mark.parametrize("segments, distance", [
    (([0.0, 0, 0], [1.0, 0, 0], [0.0, 1, 0], [1.0, 1, 0]), 1.0),  # parallel
    (([-1.0, 0, 0], [1.0, 0, 0], [0.0, -1, 0.5], [0.0, 1, 0.5]), 0.5),  # crossing
    (([0.0, 0, 0], [0.0, 0, 0], [3.0, 4, 0], [3.0, 4, 0]), 5.0),  # two points
], ids=["parallel", "crossing", "degenerate"])
def test_segment_closest(segments, distance):
    (p, q), want = both(lambda P: P.world._segment_closest(*map(np.array, segments)))
    assert abs(np.linalg.norm(p - q) - distance) < 1e-12
    assert np.array_equal(p, want[0]) and np.array_equal(q, want[1])


@pytest.mark.parametrize("interior", [0, 5], ids=["cube", "cube with interior points"])
def test_hull_keeps_the_corners_wound_outward(interior):
    pts = np.concatenate([CUBE, np.zeros((interior, 3))])
    (verts, tris), want = both(lambda P: P.world._hull_mesh(pts))
    assert verts.shape[0] == 8
    for t in tris:
        a, b, c = verts[t]
        assert np.cross(b - a, c - a) @ ((a + b + c) / 3) > 0
    assert np.array_equal(verts, want[0]) and np.array_equal(tris, want[1])


def massive(P, kind):
    """A body whose mass (or inertia) comes from its shape. Returns (world, handle)."""
    w = P.PhysicsWorld()
    if kind == "capsule":
        shape, motion = P.ShapeCapsule(0.1, 0.2), P.PhysicsMotion(mass=0.0)
    elif kind == "cylinder":
        shape, motion = P.ShapeCylinder(radius=0.3, half_height=0.25), P.PhysicsMotion(mass=2.0)
    else:
        shape, motion = P.ShapeConvexHull(0.1 * CUBE), P.PhysicsMotion(mass=0.0)
    return w, w.add_body(shape, position=(0, 5, 0), motion=motion)


@pytest.mark.parametrize("kind", ["capsule", "cylinder", "hull"])
def test_mass_properties_from_the_shape(kind):
    """A capsule's mass between its cylinder's and its sphere's, a cylinder's inertia in
    closed form, a hull's mass from its volume, at density 1000."""
    (w, h), (r, _) = both(massive, kind)
    b = w.bodies[h]
    if kind == "capsule":
        assert abs(1.0 / b.inv_mass - 1000 * (np.pi * 0.01 * 0.4 + 4 / 3 * np.pi * 0.001)) < 1e-9
    elif kind == "cylinder":
        inertia = np.linalg.inv(b.inv_inertia_local)
        ix, iy = 2.0 * (3 * 0.09 + 4 * 0.0625) / 12, 2.0 * 0.09 / 2
        assert np.allclose(np.diag(inertia), [ix, iy, ix], rtol=1e-12)
    else:
        assert abs(1.0 / b.inv_mass - 1000 * 0.008) < 1e-6
    assert b.inv_mass == r.bodies[h].inv_mass
    assert np.array_equal(b.inv_inertia_local, r.bodies[h].inv_inertia_local)


def at_rest(P, kind):
    """A shape dropped onto a floor. Returns (world, handle)."""
    w = P.PhysicsWorld()
    if kind == "capsule on a box":
        w.add_body(P.ShapeBox((2.0, 0.25, 2.0)), position=(0, -0.25, 0), static=True)
        return w, w.add_body(P.ShapeCapsule(0.15, 0.3), quat=LYING, position=(0, 0.5, 0),
                             motion=P.PhysicsMotion(mass=1.0))
    w.add_body(P.ShapePlane())
    if kind == "lying capsule":
        return w, w.add_body(P.ShapeCapsule(radius=0.2, half_height=0.4), position=(0, 0.3, 0),
                             quat=LYING, motion=P.PhysicsMotion(mass=1.0))
    if kind == "upright cylinder":
        return w, w.add_body(P.ShapeCylinder(radius=0.3, half_height=0.25),
                             position=(0, 0.5, 0), motion=P.PhysicsMotion(mass=2.0))
    pts = np.random.default_rng(3).standard_normal((40, 3)) * 0.2
    return w, w.add_body(P.ShapeConvexHull(pts), position=(0, 1.0, 0),
                         motion=P.PhysicsMotion(mass=1.0))


@pytest.mark.parametrize("kind, steps, low, high, speed", [
    ("lying capsule", 480, 0.18, 0.22, 0.05),  # at its radius
    ("capsule on a box", 600, 0.12, 0.18, None),
    ("upright cylinder", 600, 0.22, 0.28, None),  # at its half height, not tipped
    ("random hull", 720, 0.0, 0.5, 0.1),
])
def test_shape_comes_to_rest(kind, steps, low, high, speed):
    (w, h), (r, _) = both(at_rest, kind)
    lockstep(w, r, steps)
    b = w.bodies[h]
    assert low < b.pos[1] < high
    if speed is not None:
        assert np.linalg.norm(b.vel) < speed
    if kind == "upright cylinder":
        up = np.array([0.0, 1.0, 0.0])
        assert PORT.world._quat_rotate(b.quat, up) @ up > 0.99


def capsule_pair(P, kind):
    """Two bodies that meet: a sphere dropped onto a standing capsule, or two floating
    capsules overlapping. Returns (world, a, b)."""
    w = P.PhysicsWorld()
    if kind == "sphere onto capsule":
        w.add_body(P.ShapePlane())
        a = w.add_body(P.ShapeCapsule(0.2, 0.4), position=(0, 0.65, 0),
                       motion=P.PhysicsMotion(mass=1.0))
        return w, a, w.add_body(P.ShapeSphere(0.2), position=(0.05, 1.8, 0),
                                motion=P.PhysicsMotion(mass=0.5), report_contacts=True)
    a, b = (w.add_body(P.ShapeCapsule(0.3, 0.5), position=(x, 0, 0),
                       motion=P.PhysicsMotion(mass=1.0, gravity_factor=0.0)) for x in (0, 0.4))
    return w, a, b


def test_sphere_strikes_a_capsule():
    (w, cap, sph), (r, *_) = both(capsule_pair, "sphere onto capsule")
    hits = []

    def watch(pw, rw):
        hits.extend(i for i in pw.impacts if {i.body_a, i.body_b} == {cap, sph})
        pw.impacts.clear()
        rw.impacts.clear()

    lockstep(w, r, 480, watch)
    assert hits


def test_overlapping_capsules_separate():
    (w, a, b), (r, *_) = both(capsule_pair, "two capsules")
    lockstep(w, r, 240)
    assert np.linalg.norm(w.bodies[a].pos - w.bodies[b].pos) > 0.55  # toward 0.6 apart


def hinged(P, **hinge):
    """A bob on a hinge about z through a static anchor, no damping. Returns (world, bob,
    joint)."""
    w = P.PhysicsWorld()
    anchor = w.add_body(P.ShapeSphere(0.05), position=(0, 2, 0), static=True)
    bob = w.add_body(P.ShapeSphere(0.1), position=(0.5, 2, 0),
                     motion=P.PhysicsMotion(mass=1.0, linear_damping=0.0, angular_damping=0.0))
    return w, bob, w.add_hinge_joint(anchor, bob, world_anchor=(0, 2, 0), world_axis=(0, 0, 1),
                                     **hinge)


@pytest.mark.parametrize("check", ["length", "plane"])
def test_hinge_pendulum(check):
    """The point constraint keeps the rod's length; the hinge keeps the swing in its
    plane."""
    (w, bob, _), (r, *_) = both(hinged)
    lockstep(w, r, 480)
    pos = w.bodies[bob].pos
    if check == "length":
        assert abs(np.linalg.norm(pos - np.array([0, 2, 0])) - 0.5) < 0.05
    else:
        assert abs(pos[2]) < 0.02


def test_hinge_limit_holds():
    (w, _bob, jid), (r, *_) = both(hinged, limit_min=-0.4, limit_max=0.4)
    lockstep(w, r, 960)
    assert -0.6 < w.hinge_angle(jid) < 0.6  # soft overshoot allowed
    assert w.hinge_angle(jid) == r.hinge_angle(jid)


def test_hinge_motor_spins():
    (w, bob, _), (r, *_) = both(hinged, motor_velocity=2.0, motor_max_torque=50.0)
    lockstep(w, r, 240)
    assert abs(w.bodies[bob].ang[2]) > 0.5  # the motor drives rotation about the axis


def shapes_registry(P, pipeline):
    """A capsule, a cylinder (without `pipeline`) and an icosphere convex hull as rigid
    bodies in a registry."""
    r = P.Registry()
    c = P.components
    if pipeline:
        P.install_default_pipeline(r)
    cap = r.create()
    r.emplace(cap, c.RigidBodyComponent(shape_kind="capsule", radius=0.2,
                                        half_height=0.4 if pipeline else 0.7, is_dynamic=True,
                                        mass=1.0 if pipeline else 2.0))
    if not pipeline:
        cyl = r.create()
        r.emplace(cyl, c.RigidBodyComponent(shape_kind="cylinder", radius=0.4, half_height=0.3,
                                            is_dynamic=True))
    cvx = r.create()
    pos, tris = P.mesh.icosphere_surface(1)
    r.emplace(cvx, c.MeshSurface(positions=pos, triangles=np.asarray(tris, np.uint32)))
    r.emplace(cvx, c.RigidBodyComponent(shape_kind="convex", is_dynamic=True,
                                        **({"mass": 1.0} if pipeline else {})))
    return r


def test_shapes_round_trip_through_gltf(tmp_path):
    """The port's exporter writes what the reference's writes, byte for byte, and its
    importer gives the shapes back."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    export_gltf(shapes_registry(PORT, False), port / "shapes.gltf")
    ref_gltf.export_gltf(shapes_registry(REF, False), ref / "shapes.gltf")
    for name in ("shapes.gltf", "shapes.bin"):
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    kinds = {rb.shape_kind: rb for _, rb in
             import_gltf(port / "shapes.gltf").view(PORT.components.RigidBodyComponent)}
    assert set(kinds) == {"capsule", "cylinder", "convex"}
    assert abs(kinds["capsule"].radius - 0.2) < 1e-12
    assert abs(kinds["capsule"].half_height - 0.7) < 1e-12
    assert abs(kinds["cylinder"].radius - 0.4) < 1e-12
    assert abs(kinds["cylinder"].half_height - 0.3) < 1e-12


def test_scene_build_constructs_the_shapes():
    def world(P):
        r = shapes_registry(P, True)
        r.process()
        return P.build_world(r)

    (w, handles), (rw, ref_handles) = both(world)
    assert len(w.bodies) == 2 and handles == ref_handles
    lockstep(w, rw, 10)  # steps without error
