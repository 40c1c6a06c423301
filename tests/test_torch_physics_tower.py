"""The reference's box tower (tests/test_physics.py) on the port's physics, stepped in
lockstep with the reference's world and held bit for bit (tests/test_torch_physics.py says
how). It has a file of its own: its 960 steps of three stacked boxes take about 90 s a
package on one CPU core."""

import numpy as np

from test_torch_physics import _one_thread, both, lockstep  # noqa: F401


def box_tower(P):
    w = P.PhysicsWorld()
    w.add_body(P.ShapePlane(), static=True)
    boxes = [w.add_body(P.ShapeBox((0.05, 0.05, 0.05)),
                        position=(0.002 * k, 0.05 + 0.11 * k, 0.0),
                        motion=P.PhysicsMotion(mass=1.0)) for k in range(3)]
    return w, boxes


def test_box_tower_stands():
    """Three offset boxes dropped 1 cm each stack at their rest heights: face-clip
    manifolds keep the contact torque symmetric."""
    (w, boxes), (r, _) = both(box_tower)
    lockstep(w, r, 960)
    for k, h in enumerate(boxes):
        p = w.bodies[h].pos
        assert abs(p[1] - (0.05 + 0.1 * k)) < 0.005, (k, p)
        assert np.linalg.norm(p[[0, 2]] - [0.002 * k, 0.0]) < 0.05, (k, p)
