"""The inputs every cell makes from its seed, handed alike to the program and to the
reference: the meshes (copies of the program's `box_tets` and `torus_surface`,
mesheditor_tpu_torch/mesh/primitives.py, so the inputs are the benchmark's own), rigid
motions, excitation points, the play cells' modal bank, their strike stream and their
sliding contacts.

Every draw comes from numpy generators seeded by (seed, purpose, index), so one unit's
inputs are the same whatever ran before it, and every seed draws the same sizes.
"""

from __future__ import annotations

import numpy as np

# Sub-streams of a seed.
MOTION, EXCITE, BANK, STRIKES, CONTACTS, SAMPLE = range(6)


def rng(seed: int, *key) -> np.random.Generator:
    """A generator for one purpose and index of a seed (negative indices are warm-up's)."""
    return np.random.default_rng([int(seed) % 2**63,
                                  *(k if k >= 0 else 2**40 - k for k in map(int, key))])


def box_tets(extents, resolution):
    """Structured tets of an axis-aligned box: (nx+1)(ny+1)(nz+1) vertices numbered
    ((i*vy + j)*vz + k), each cell split into six tets around its main diagonal."""
    lx, ly, lz = extents
    nx, ny, nz = resolution
    vx, vy, vz = nx + 1, ny + 1, nz + 1
    grid = np.stack(np.meshgrid(np.linspace(0.0, lx, vx), np.linspace(0.0, ly, vy),
                                np.linspace(0.0, lz, vz), indexing="ij"), axis=-1)
    points = grid.reshape(-1, 3)

    def vid(i, j, k):
        return (i * vy + j) * vz + k

    ii, jj, kk = (a.reshape(-1) for a in np.meshgrid(np.arange(nx), np.arange(ny),
                                                     np.arange(nz), indexing="ij"))
    corners = np.stack([vid(ii, jj, kk), vid(ii + 1, jj, kk), vid(ii, jj + 1, kk),
                        vid(ii + 1, jj + 1, kk), vid(ii, jj, kk + 1), vid(ii + 1, jj, kk + 1),
                        vid(ii, jj + 1, kk + 1), vid(ii + 1, jj + 1, kk + 1)], axis=-1)
    kuhn = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                     [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])
    return points, corners[:, kuhn].reshape(-1, 4).astype(np.uint32)


def boundary_vertices(resolution) -> np.ndarray:
    """Ids of the box mesh's vertices on its surface."""
    nx, ny, nz = resolution
    i, j, k = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1),
                          indexing="ij")
    on = (i == 0) | (i == nx) | (j == 0) | (j == ny) | (k == 0) | (k == nz)
    return np.flatnonzero(on.reshape(-1))


def torus_surface(major, minor, n_major, n_minor):
    u = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = major + minor * np.cos(vv)
    pts = np.stack([r * np.cos(uu), r * np.sin(uu), minor * np.sin(vv)], -1).reshape(-1, 3)

    def vid(i, j):
        return (i % n_major) * n_minor + (j % n_minor)

    ii, jj = (a.reshape(-1) for a in np.meshgrid(np.arange(n_major), np.arange(n_minor),
                                                 indexing="ij"))
    a, b, c, d = vid(ii, jj), vid(ii + 1, jj), vid(ii + 1, jj + 1), vid(ii, jj + 1)
    tris = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=0)
    return pts, tris.astype(np.uint32)


def rotation(g: np.random.Generator) -> np.ndarray:
    """A uniformly random proper rotation."""
    q = g.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def solve_call(seed: int, index: int, points: np.ndarray, surface_ids: np.ndarray,
               n_excite: int, rotate: bool, shift: float):
    """The inputs of the window's `index`-th solve: the points under a rigid motion drawn
    for it (a rotation when `rotate`, and a shift of up to `shift` m on each axis), and
    `n_excite` distinct surface vertices to excite, at their moved positions."""
    g = rng(seed, MOTION, index)
    rot = rotation(g) if rotate else np.eye(3)
    moved = points @ rot.T + g.uniform(-shift, shift, 3)
    pick = rng(seed, EXCITE, index).choice(surface_ids, n_excite, replace=False)
    return moved, moved[pick]


def modal_bank(seed: int, play: dict, material: dict) -> list:
    """The play cells' modal models, one per object: `modes` frequencies from a
    per-object fundamental near `f1_hz` up to `f_top_hz` with the 3-D mode density
    (N(f) ~ f^3), jittered; T60s from the material's Rayleigh damping; mass-normalised
    shapes at `positions` points, N(0, 1/(3 m)) per component; the points on the box.
    Returns [(freqs, t60s, shapes (P, K, 3) float32, positions (P, 3))]."""
    g = rng(seed, BANK)
    k, p = play["modes"], play["positions"]
    ext = np.asarray(play["extents"], np.float64)
    mass = material["density"] * float(np.prod(ext))
    out = []
    for _ in range(play["objects"]):
        f1 = play["f1_hz"] * (1.0 + g.uniform(-play["jitter"], play["jitter"]))
        top = play["f_top_hz"] * (1.0 + g.uniform(-play["jitter"], play["jitter"]))
        u = np.sort(g.uniform(0.0, 1.0, k))
        u[0] = 0.0
        freqs = np.cbrt(f1 ** 3 + u * (top ** 3 - f1 ** 3))
        omega = 2 * np.pi * freqs
        c = material["alpha"] + material["beta"] * omega ** 2
        t60s = 2 * np.log(1000.0) / c
        shapes = (g.normal(size=(p, k, 3)) / np.sqrt(3 * mass)).astype(np.float32)
        face = g.integers(0, 3, p)
        pos = g.uniform(0.0, 1.0, (p, 3)) * ext
        pos[np.arange(p), face] = np.where(g.uniform(size=p) < 0.5, 0.0, ext[face])
        out.append((freqs.astype(np.float32), t60s.astype(np.float32), shapes, pos))
    return out


def box_dynamics(play: dict, material: dict):
    """Closed-form mass, inverse inertia and centre of mass of the solid box."""
    a, b, c = play["extents"]
    m = material["density"] * a * b * c
    inertia = m / 12.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
    return m, np.diag(1.0 / inertia), 0.5 * np.asarray(play["extents"], np.float64)


def strikes_in_block(seed: int, block: int, traffic: dict, n_objects: int, n_points: int,
                     block_samples: int, sample_rate: float) -> list:
    """The strikes due in one block: a Poisson count at `strike_rate` a second, each with
    an object, a sample point, a direction, an impulse, a contact time and a click
    amplitude. Returns [(obj, expos, impulse (3,), tau_s, accel_amp)]."""
    rate = traffic.get("strike_rate", 0.0)
    if rate <= 0:
        return []
    g = rng(seed, STRIKES, block)
    n = int(g.poisson(rate * block_samples / sample_rate))
    out = []
    for _ in range(n):
        d = g.normal(size=3)
        d /= np.linalg.norm(d)
        impulse = d * g.uniform(*traffic["impulse"])
        tau = g.uniform(*traffic["contact_ms"]) * 1e-3
        out.append((int(g.integers(n_objects)), int(g.integers(n_points)), impulse, tau,
                    float(g.uniform(*traffic["accel_amp"]))))
    return out


def contacts(seed: int, traffic: dict, positions_of) -> list:
    """The sliding contacts between objects (2c, 2c + 1): a normal near +y, a point at one
    of the first object's sample points, a load, slip and sweep speeds, friction and
    restitution (the pattern of chip_smoke.py's sustained scene). `positions_of(obj)`
    gives an object's sample points."""
    g = rng(seed, CONTACTS)
    out = []
    for c in range(traffic.get("contacts", 0)):
        normal = np.array([0.0, 1.0, 0.0]) + g.normal(0.0, 0.1, 3)
        pos = positions_of(2 * c)
        out.append(dict(contact_id=c, body_a=2 * c, body_b=2 * c + 1,
                        point=pos[g.integers(len(pos))], normal=normal / np.linalg.norm(normal),
                        normal_force=float(g.uniform(*traffic["normal_force"])),
                        slip_speed=float(g.uniform(*traffic["slip_speed"])),
                        sweep_speed_a=float(g.uniform(*traffic["sweep_speed"])),
                        sweep_speed_b=float(g.uniform(*traffic["sweep_speed"])),
                        friction=traffic["friction"], restitution=traffic["restitution"]))
    return out
