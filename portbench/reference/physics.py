"""The reference's rigid-body step: one fixed step of a scene of spheres, boxes and static
planes, written from the semantics the program states (mesheditor_tpu_torch/physics/world.py
and types.py) in plain NumPy, in float64 (its control in float32):

- semi-implicit Euler: gravity times the body's gravity factor into the velocity, then the
  linear and angular damping factors max(0, 1 - c dt), then the contact solve, then the
  position by the velocity and the orientation (a unit quaternion, w first) by the exact
  rotation of the angular velocity over dt;
- contacts, each (body 1, body 2, point, normal from body 2 into body 1, depth), pair by
  pair in ascending handle order (pairs of two static bodies skipped):
  - sphere-plane: the sphere's lowest point; box-plane: each penetrating corner, corners in
    (x, y, z) sign order;
  - sphere-sphere: the point on the second sphere's surface along the centre line;
  - sphere-box: the box's closest point to the sphere's centre (the sphere is body 1);
  - box-box: the face-clip manifold of each box's incident face against the other's
    reference face (first a against b, then b against a; the reference axis the one of
    largest |centre offset| / (its half extent + the other box's largest half extent)),
    and only where that is empty the edge-edge contact of a separating-axis test over the
    15 axes when the deepest-penetration axis (edge axes weighted 1.05) is an edge cross;
- sequential impulses with the world's fixed iteration count (10), contact after contact:
  the normal impulse accumulated and clamped at 0, aiming at -e max(v_approach - 0.02, 0)
  (restitution slop) plus a positional bias 0.2/dt max(depth - 1e-4, 0); then Coulomb
  friction against the accumulated normal impulse along the tangential slip; restitution
  and friction combined by the first body's combine rule (the average by default);
- the reports: an impact for each contact of a pair that was not touching in the last
  step, approaching faster than 1e-4 m/s and holding a positive impulse (direction from
  body 1 into body 2's side, -normal; the other inverse mass is body 2's); a sustained
  contact for each pair that was touching or holds a positive impulse, the pair's last such
  contact point giving its values (normal force = impulse / dt, slip, each side's sweep).

Departures from physics/world.py, none of which changes a value beyond rounding:
- the state is arrays (N bodies x 3 or 4) and the scene a list of `Body`; handles are the
  bodies' 1-based indices;
- each body's world inverse inertia is computed once a step (it is fixed while the solver
  runs), where the program recomputes it at every contact of every iteration;
- box corners and the face-clip polygon are built with array operations;
- only the shapes the falling scene uses (sphere, box, static plane): no capsule, mesh,
  cylinder or hull, no joints, no collision filters, no kinematic bodies.

Imports nothing of the program or of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Body:
    """One body: `shape` "sphere" (size: radius), "box" (size: half extents) or "plane"
    (size: normal and offset, normal . x = offset; always static); `mass` 0 for a static
    body; the physics material's restitution and dynamic friction, combined by averaging;
    the motion's damping and gravity factor (the program's defaults)."""

    shape: str
    size: tuple
    mass: float = 0.0
    restitution: float = 0.3
    friction: float = 0.5
    linear_damping: float = 0.02
    angular_damping: float = 0.05
    gravity_factor: float = 1.0

    @property
    def static(self) -> bool:
        return self.shape == "plane" or self.mass <= 0

    def inv_inertia(self) -> np.ndarray:
        """The inverse of the body-local inertia (solid sphere, solid box)."""
        if self.static:
            return np.zeros(3)
        m = self.mass
        if self.shape == "sphere":
            return 1.0 / np.full(3, 0.4 * m * self.size[0] ** 2)
        hx, hy, hz = self.size
        return 1.0 / np.array([m / 3 * (hy ** 2 + hz ** 2), m / 3 * (hx ** 2 + hz ** 2),
                               m / 3 * (hx ** 2 + hy ** 2)])


@dataclass
class State:
    """The scene's dynamic state: pos (N, 3), quat (N, 4) w first, vel (N, 3), ang (N, 3),
    and the pairs (i, j), i < j, 0-based, that touched at the end of the last step."""

    pos: np.ndarray
    quat: np.ndarray
    vel: np.ndarray
    ang: np.ndarray
    touching: frozenset = frozenset()

    def astype(self, dtype) -> "State":
        return State(*(np.array(a, dtype) for a in (self.pos, self.quat, self.vel, self.ang)),
                     self.touching)


def contact_id(i: int, j: int) -> int:
    """The program's contact id of bodies i and j (0-based): its handles are i + 1, j + 1."""
    a, b = sorted((i + 1, j + 1))
    return (a << 20) | b


def quat_to_mat(q):
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def segment_closest(p1, q1, p2, q2):
    """Closest points of segments [p1, q1] and [p2, q2] (Ericson 5.1.9)."""
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a, e, f = d1 @ d1, d2 @ d2, d2 @ r
    if a < 1e-24 and e < 1e-24:
        return p1, p2
    if a < 1e-24:
        s, t = 0.0, np.clip(f / e, 0.0, 1.0)
    else:
        c = d1 @ r
        if e < 1e-24:
            s, t = np.clip(-c / a, 0.0, 1.0), 0.0
        else:
            b = d1 @ d2
            denom = a * e - b * b
            s = np.clip((b * f - c * e) / denom, 0.0, 1.0) if denom > 1e-24 else 0.0
            t = (b * s + f) / e
            if t < 0:
                t, s = 0.0, np.clip(-c / a, 0.0, 1.0)
            elif t > 1:
                t, s = 1.0, np.clip((b - c) / a, 0.0, 1.0)
    return p1 + s * d1, p2 + t * d2


class _Scene:
    """One step's working set: the bodies, their state arrays (updated in place) and
    each body's rotation."""

    def __init__(self, bodies, state: State, dtype):
        self.bodies, self.dtype = bodies, dtype
        s = state.astype(dtype)
        self.pos, self.quat, self.vel, self.ang = s.pos, s.quat, s.vel, s.ang
        self.rot = [quat_to_mat(q) for q in self.quat]

    def corners(self, i):
        """The 8 world corners of box i, sign order (-,-,-), (-,-,+), ..., (+,+,+)."""
        he = np.asarray(self.bodies[i].size, self.dtype)
        signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                         self.dtype)
        return [self.pos[i] + self.rot[i] @ (he * s) for s in signs]


def _plane(sc: _Scene, i, k):
    """Body i (sphere or box) against the static plane k."""
    b, plane = sc.bodies[i], sc.bodies[k]
    n = np.asarray(plane.size[:3], sc.dtype)
    n = n / np.linalg.norm(n)
    off = sc.dtype(plane.size[3])
    if b.shape == "sphere":
        r = sc.dtype(b.size[0])
        dist = sc.pos[i] @ n - off - r
        return [(i, k, sc.pos[i] - n * r, n, -dist)] if dist < 0 else []
    out = []
    for corner in sc.corners(i):
        dist = corner @ n - off
        if dist < 0:
            out.append((i, k, corner, n, -dist))
    return out


def _spheres(sc: _Scene, i, k):
    d = sc.pos[i] - sc.pos[k]
    dist = np.linalg.norm(d)
    rsum = sc.dtype(sc.bodies[i].size[0]) + sc.dtype(sc.bodies[k].size[0])
    if rsum > dist > 1e-12:
        n = d / dist
        return [(i, k, sc.pos[k] + n * sc.dtype(sc.bodies[k].size[0]), n, rsum - dist)]
    return []


def _sphere_box(sc: _Scene, s, k):
    """Sphere s against box k; the sphere is body 1."""
    r = sc.rot[k]
    local = r.T @ (sc.pos[s] - sc.pos[k])
    he = np.asarray(sc.bodies[k].size, sc.dtype)
    closest = np.clip(local, -he, he)
    d = local - closest
    dist = np.linalg.norm(d)
    radius = sc.dtype(sc.bodies[s].size[0])
    if radius > dist > 1e-12:
        return [(s, k, sc.pos[k] + r @ closest, r @ (d / dist), radius - dist)]
    return []


def _face_clip(sc: _Scene, i, k):
    """Box i's incident face clipped against box k's reference face (Sutherland-Hodgman in
    k's frame); a contact at each clipped vertex below the reference face."""
    ra, rb = sc.rot[i], sc.rot[k]
    hea = np.asarray(sc.bodies[i].size, sc.dtype)
    heb = np.asarray(sc.bodies[k].size, sc.dtype)
    rel = rb.T @ (sc.pos[i] - sc.pos[k])
    axis = int(np.argmax(np.abs(rel) / (heb + np.max(hea))))
    sign = 1.0 if rel[axis] >= 0 else -1.0
    n = rb[:, axis] * sign
    n_in_a = ra.T @ n
    face = int(np.argmax(np.abs(n_in_a)))
    face_sign = -1.0 if n_in_a[face] >= 0 else 1.0
    u, v = [a for a in range(3) if a != face]
    poly = []
    for su, sv in ((-1, -1), (-1, 1), (1, 1), (1, -1)):  # the face's rectangle, wound
        c = np.zeros(3, sc.dtype)
        c[face], c[u], c[v] = face_sign * hea[face], su * hea[u], sv * hea[v]
        poly.append(rb.T @ (sc.pos[i] + ra @ c - sc.pos[k]))
    for t in [a for a in range(3) if a != axis]:
        for side in (1.0, -1.0):
            clipped = []
            for j in range(len(poly)):
                p, q = poly[j], poly[(j + 1) % len(poly)]
                dp, dq = side * p[t] - heb[t], side * q[t] - heb[t]
                if dp <= 0:
                    clipped.append(p)
                if (dp <= 0) != (dq <= 0):
                    clipped.append(p + dp / (dp - dq) * (q - p))
            poly = clipped
            if not poly:
                return []
    out = []
    for p in poly:
        depth = heb[axis] - sign * p[axis]
        if depth > 0:
            out.append((i, k, sc.pos[k] + rb @ p, n, depth))
    return out


def _edge(sc: _Scene, i, k):
    """The edge-edge contact of boxes i and k by the separating-axis test, or none when
    they are apart or the deepest-penetration axis is a face axis."""
    ra, rb = sc.rot[i], sc.rot[k]
    hea = np.asarray(sc.bodies[i].size, sc.dtype)
    heb = np.asarray(sc.bodies[k].size, sc.dtype)
    d = sc.pos[i] - sc.pos[k]
    axes = [(ra[:, a], None) for a in range(3)] + [(rb[:, a], None) for a in range(3)]
    for a in range(3):
        for b in range(3):
            cx = np.cross(ra[:, a], rb[:, b])
            nn = np.linalg.norm(cx)
            if nn > 1e-9:
                axes.append((cx / nn, (a, b)))
    best, best_axis, best_pair = np.inf, None, None
    for axis, pair in axes:
        pen = np.abs(axis @ ra) @ hea + np.abs(axis @ rb) @ heb - abs(axis @ d)
        if pen < 0:
            return []
        if pair is not None:
            pen = pen * 1.05
        if pen < best:
            best, best_axis, best_pair = pen, axis, pair
    if best_pair is None:
        return []
    a, b = best_pair
    n = best_axis if best_axis @ d >= 0 else -best_axis
    ca, cb = sc.pos[i].copy(), sc.pos[k].copy()
    for j in range(3):
        if j != a:
            ca = ca - np.sign(n @ ra[:, j]) * hea[j] * ra[:, j]
        if j != b:
            cb = cb + np.sign(n @ rb[:, j]) * heb[j] * rb[:, j]
    pa, pb = segment_closest(ca - hea[a] * ra[:, a], ca + hea[a] * ra[:, a],
                             cb - heb[b] * rb[:, b], cb + heb[b] * rb[:, b])
    return [(i, k, 0.5 * (pa + pb), n, best / 1.05)]


def contacts(sc: _Scene) -> list:
    out = []
    bodies = sc.bodies
    for i in range(len(bodies)):
        for k in range(i + 1, len(bodies)):
            a, b = bodies[i].shape, bodies[k].shape
            if bodies[i].static and bodies[k].static:
                continue
            if a == "plane":
                out += _plane(sc, k, i)
            elif b == "plane":
                out += _plane(sc, i, k)
            elif a == b == "sphere":
                out += _spheres(sc, i, k)
            elif a == "sphere":
                out += _sphere_box(sc, i, k)
            elif b == "sphere":
                out += _sphere_box(sc, k, i)
            else:
                face = _face_clip(sc, i, k) + _face_clip(sc, k, i)
                out += face if face else _edge(sc, i, k)
    return out


def step(bodies, state: State, dt: float, gravity=(0.0, -9.81, 0.0), iterations: int = 10,
         dtype=np.float64):
    """One step from `state`. Returns (next State, impacts, sustained): impacts a list of
    dicts (body_a, body_b 0-based, point, direction, impulse, speed, other_inv_mass),
    sustained {(i, j) with i < j: dict (body_a, body_b, point, normal, normal_force,
    slip_speed, sweep_speed_a, sweep_speed_b, friction, restitution)} in first-contact
    order."""
    f = np.dtype(dtype).type
    dt = f(dt)
    sc = _Scene(bodies, state, dtype)
    g = np.asarray(gravity, dtype)
    inv_mass = [f(0.0) if b.static else f(1.0) / f(b.mass) for b in bodies]
    for i, b in enumerate(bodies):
        if b.static:
            continue
        sc.vel[i] = sc.vel[i] + g * f(b.gravity_factor) * dt
        sc.vel[i] *= max(f(0.0), f(1.0) - f(b.linear_damping) * dt)
        sc.ang[i] *= max(f(0.0), f(1.0) - f(b.angular_damping) * dt)
    # World inverse inertia, fixed while the solver runs.
    inv_inertia = [r @ np.diag(np.asarray(b.inv_inertia(), dtype)) @ r.T
                   for r, b in zip(sc.rot, bodies)]

    def vel_at(i, p):
        return sc.vel[i] + np.cross(sc.ang[i], p - sc.pos[i])

    def apply(i, k, p, imp):
        sc.vel[i] += imp * inv_mass[i]
        sc.ang[i] += inv_inertia[i] @ np.cross(p - sc.pos[i], imp)
        sc.vel[k] -= imp * inv_mass[k]
        sc.ang[k] -= inv_inertia[k] @ np.cross(p - sc.pos[k], imp)

    def mass_along(i, k, p, d):
        ra, rb = p - sc.pos[i], p - sc.pos[k]
        return (inv_mass[i] + inv_mass[k] + d @ np.cross(inv_inertia[i] @ np.cross(ra, d), ra)
                + d @ np.cross(inv_inertia[k] @ np.cross(rb, d), rb))

    found = contacts(sc)
    impulse = np.zeros(len(found), dtype)
    approach = np.array([-(vel_at(i, p) - vel_at(k, p)) @ n for i, k, p, n, _d in found],
                        dtype).reshape(-1)
    slop, bias_rate, bias_slop = f(0.02), f(0.2) / dt, f(1e-4)
    for _ in range(iterations):
        for c, (i, k, p, n, depth) in enumerate(found):
            vn = (vel_at(i, p) - vel_at(k, p)) @ n
            e = (f(bodies[i].restitution) + f(bodies[k].restitution)) * f(0.5)
            target = -e * max(approach[c] - slop, f(0.0))
            kn = mass_along(i, k, p, n)
            if kn <= 0:
                continue
            bias = bias_rate * max(depth - bias_slop, f(0.0))
            j0 = impulse[c]
            impulse[c] = max(j0 + (-(vn - target) + bias) / kn, f(0.0))
            apply(i, k, p, (impulse[c] - j0) * n)
            rel = vel_at(i, p) - vel_at(k, p)
            vt = rel - (rel @ n) * n
            vt_norm = np.linalg.norm(vt)
            if vt_norm > 1e-9:
                t = vt / vt_norm
                mu = (f(bodies[i].friction) + f(bodies[k].friction)) * f(0.5)
                jt = np.clip(-vt_norm / mass_along(i, k, p, t), -mu * impulse[c],
                             mu * impulse[c])
                apply(i, k, p, jt * t)
    impacts, sustained = [], {}
    for c, (i, k, p, n, _depth) in enumerate(found):
        pair = (min(i, k), max(i, k))
        j = impulse[c]
        if pair not in state.touching and approach[c] > 1e-4 and j > 0:
            impacts.append(dict(body_a=i, body_b=k, point=p.copy(), direction=-n,
                                impulse=j, speed=approach[c], other_inv_mass=inv_mass[k]))
        va, vb = vel_at(i, p), vel_at(k, p)
        rel = va - vb
        slip = np.linalg.norm(rel - (rel @ n) * n)
        if pair in state.touching or j > 0:
            sustained[pair] = dict(
                body_a=i, body_b=k, point=p.copy(), normal=n.copy(), normal_force=j / dt,
                slip_speed=slip, sweep_speed_a=np.linalg.norm(va - sc.vel[i]) + slip,
                sweep_speed_b=np.linalg.norm(vb - sc.vel[k]) + slip,
                friction=(f(bodies[i].friction) + f(bodies[k].friction)) * f(0.5),
                restitution=(f(bodies[i].restitution) + f(bodies[k].restitution)) * f(0.5))
    for i, b in enumerate(bodies):
        if b.static:
            continue
        sc.pos[i] = sc.pos[i] + sc.vel[i] * dt
        w = sc.ang[i]
        wn = np.linalg.norm(w)
        if wn > 1e-12:
            half = f(0.5) * wn * dt
            q = quat_mul(np.concatenate([[np.cos(half)], np.sin(half) * w / wn]), sc.quat[i])
            sc.quat[i] = q / np.linalg.norm(q)
    return State(sc.pos, sc.quat, sc.vel, sc.ang, frozenset(sustained)), impacts, sustained
