"""The benchmark's plain physics reference (portbench/reference/physics.py) against the port's
PhysicsWorld.step: from the same seeded states, one case for each contact the falling scene
meets, every step of the world held to the reference's step from the state before it, by the
falling8.scene cell's own limits and with identical report sets."""

import json

import numpy as np
import pytest

from mesheditor_tpu_torch.physics import PhysicsWorld
from mesheditor_tpu_torch.physics.types import PhysicsMotion, ShapeBox, ShapePlane, ShapeSphere
from portbench import harness
from portbench.loops import scene as scene_loop
from portbench.reference import physics as ref

LIMITS = json.loads((harness.PKG / "cells" / "falling8.scene.json").read_text())["limits"]
PHYSICS = ("pose_rel", "vel_rel", "impulse_rel", "reports")


def diamond(axis):
    """45 degrees about `axis`: a box's cross-section a diamond, touching on an edge."""
    q = [np.cos(np.pi / 8), 0.0, 0.0, 0.0]
    q[1 + axis] = np.sin(np.pi / 8)
    return np.array(q)


def random_quat(g):
    q = g.normal(size=4)
    return q / np.linalg.norm(q)


def case(name, g):
    """(bodies as (reference Body, position, quat, velocity, spin), steps, the pair that must
    touch) for one contact case, with seeded jitter."""
    plane = (ref.Body("plane", (0.0, 1.0, 0.0, 0.0)), None, None, None, None)
    one = np.array([1.0, 0.0, 0.0, 0.0])
    jit = g.uniform(-0.01, 0.01, 3)
    spin = g.normal(0.0, 2.0, 3)
    ball = ref.Body("sphere", (0.05,), 0.54)
    block = ref.Body("box", (0.08, 0.02, 0.05), 0.48)
    if name == "sphere_plane":
        return [plane, (ball, [0.0, 0.06, 0.0] + jit, one, [1.0, -1.0, 0.3], spin)], 40, (0, 1)
    if name == "box_plane":
        return [plane, (block, [0.0, 0.1, 0.0] + jit, random_quat(g), [0.5, -1.0, 0.0],
                        spin)], 40, (0, 1)
    if name == "sphere_sphere":
        return [plane, (ball, [-0.08, 0.5, 0.0] + jit, one, [1.0, 0.0, 0.1], spin),
                (ball, [0.08, 0.5, 0.0], one, [-1.0, 0.0, 0.0], -spin)], 30, (1, 2)
    if name == "sphere_box":
        return [plane, (block, [0.0, 0.02, 0.0], one, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
                (ball, [0.0, 0.09, 0.0] + jit, one, [0.2, -1.0, 0.0], spin)], 40, (1, 2)
    if name == "box_box_face":
        tilt = np.array([np.cos(0.05), 0.0, np.sin(0.05), 0.0])
        return [plane, (block, [0.0, 0.02, 0.0], one, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
                (block, [0.01, 0.055, 0.0] + jit * [1, 0, 1], tilt, [0.1, -0.8, 0.0],
                 spin * 0.1)], 40, (1, 2)
    assert name == "box_box_edge"
    diag = 0.05 * np.sqrt(2.0)
    rail = ref.Body("box", (0.05, 0.05, 0.5), 0.0)  # static
    rod = ref.Body("box", (0.5, 0.05, 0.05), 0.5)
    return [(rail, [0.0, -2 * diag + 0.004, 0.0], diamond(2), None, None),
            (rod, [0.0, 0.0, 0.0] + jit * [1, 0, 1], diamond(0), [0.0, -0.2, 0.0],
             spin * 0.05)], 20, (0, 1)


def world_of(spec):
    w = PhysicsWorld()
    for body, pos, quat, vel, spin in spec:
        if body.shape == "plane":
            w.add_body(ShapePlane(normal=body.size[:3], offset=body.size[3]),
                       report_contacts=True)
            continue
        shape = ShapeSphere(body.size[0]) if body.shape == "sphere" else ShapeBox(body.size)
        h = w.add_body(shape, position=pos, quat=quat, report_contacts=True,
                       motion=None if body.static else PhysicsMotion(mass=body.mass),
                       static=body.static)
        if not body.static:
            w.bodies[h].vel = np.asarray(vel, np.float64).copy()
            w.bodies[h].ang = np.asarray(spin, np.float64).copy()
    return w


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
@pytest.mark.parametrize("name", ["sphere_plane", "box_plane", "sphere_sphere", "sphere_box",
                                  "box_box_face", "box_box_edge"])
def test_the_reference_steps_as_the_world_does(name, seed):
    spec, steps, pair = case(name, np.random.default_rng(seed))
    bodies = [s[0] for s in spec]
    world = world_of(spec)
    touched = edge_steps = 0
    for _ in range(steps):
        before = scene_loop.world_state(world)
        if name == "box_box_edge":
            sc = ref._Scene(bodies, before, np.float64)
            edge_steps += not (ref._face_clip(sc, 0, 1) + ref._face_clip(sc, 1, 0)) and \
                bool(ref._edge(sc, 0, 1))
        want = ref.step(bodies, before, world.dt)
        world.step()
        got = (scene_loop.world_state(world), scene_loop.impact_dicts(world.impacts),
               scene_loop.sustained_dicts(world.sustained))
        gaps = scene_loop.step_gaps(got, want)
        assert gaps["reports"] == 0, (world.step_count, gaps)
        for k in PHYSICS:
            assert gaps[k] <= LIMITS[k], (world.step_count, k, gaps)
        touched += pair in want[2]
    assert touched > 0, f"{name}: bodies {pair} never touched"
    assert name != "box_box_edge" or edge_steps > 0, "no step took the edge contact"


def test_the_scene_references_load_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import json, sys\n"
            "from portbench.reference import physics, scene, sparse_fem\n"
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('mesheditor_tpu_torch', 'mesheditor_tpu', 'jax'))))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
