"""The reference's bodies coming to rest (tests/test_physics.py) on the port's physics: a
box and a mesh solid on a plane, a sphere on static mesh terrain and a mesh ball on a mesh
crate, each world stepped in lockstep with the reference's and held bit for bit
(tests/test_torch_physics.py says how, and why these sit in a file of their own)."""

import numpy as np
import pytest

from test_torch_physics import _one_thread, both, lockstep  # noqa: F401


def resting(P, kind):
    """One body dropped onto a floor, as the rest cases build it. Returns (world, handle)."""
    w = P.PhysicsWorld()
    if kind == "terrain":
        pts, tris = P.mesh.grid_box_surface(3)
        w.add_body(P.ShapeMesh(positions=pts * np.array([2.0, 0.2, 2.0]), triangles=tris),
                   position=(0, 0, 0))
        return w, w.add_body(P.ShapeSphere(0.05), position=(0.5, 0.6, 0.5),
                             motion=P.PhysicsMotion(mass=0.5))
    w.add_body(P.ShapePlane(), static=True)
    if kind == "box":
        return w, w.add_body(P.ShapeBox((0.1, 0.1, 0.1)), position=(0, 0.3, 0))
    pts, tris = P.mesh.cuboid_surface((0.05, 0.05, 0.05))  # "mesh solid"
    return w, w.add_body(P.ShapeMesh(positions=pts, triangles=tris), position=(0, 0.3, 0),
                         motion=P.PhysicsMotion(mass=0.0))  # mass from enclosed volume


@pytest.mark.parametrize("kind, steps, height, tol, speed", [
    ("box", 960, 0.1, 0.03, 0.1),
    ("mesh solid", 960, 0.05, 0.005, 1e-3),  # 1 L of water-density solid, on a face
    ("terrain", 720, 0.25, 0.01, None),  # on a static mesh slab: top 0.2 + radius
])
def test_body_comes_to_rest(kind, steps, height, tol, speed):
    (w, h), (r, _) = both(resting, kind)
    if kind == "mesh solid":
        assert abs(1.0 / w.bodies[h].inv_mass - 1.0) < 1e-6
    lockstep(w, r, steps)
    b = w.bodies[h]
    assert abs(b.pos[1] - height) < tol
    if speed is not None:
        assert np.linalg.norm(b.vel) < speed


def mesh_stack(P):
    w = P.PhysicsWorld()
    w.add_body(P.ShapePlane(), static=True)
    cpts, ctris = P.mesh.cuboid_surface((0.1, 0.05, 0.1))
    crate = w.add_body(P.ShapeMesh(positions=cpts, triangles=ctris), position=(0, 0.05, 0),
                       motion=P.PhysicsMotion(mass=2.0))
    spts, stris = P.mesh.icosphere_surface(1)
    ball = w.add_body(P.ShapeMesh(positions=spts * 0.04, triangles=stris),
                      position=(0.01, 0.18, 0.0), motion=P.PhysicsMotion(mass=0.3))
    return w, crate, ball


def test_mesh_ball_rests_on_mesh_crate():
    (w, crate, ball), (r, *_) = both(mesh_stack)
    lockstep(w, r, 360)
    assert abs(w.bodies[crate].pos[1] - 0.05) < 0.005
    assert abs(w.bodies[ball].pos[1] - 0.14) < 0.01  # crate top + ball radius
