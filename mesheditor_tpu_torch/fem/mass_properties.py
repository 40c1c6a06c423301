"""Lumped-vertex rigid-body mass properties in SI at the baked size.

Each tet's volume splits evenly onto its four vertices as point masses; inertia is the
point-mass sum about the center of mass, scaled to SI (inertia integral ~ length^5).
Semantics mirror the reference's ComputeMassProperties (src/audio/mesh2modes.cpp:71-126),
fully vectorized with numpy.
"""

from __future__ import annotations

import numpy as np

from ..types import MassProperties


def _quat_from_matrix(r: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) from a proper rotation matrix (columns are axes)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        w = (r[2, 1] - r[1, 2]) / s
        x = 0.25 * s
        y = (r[0, 1] + r[1, 0]) / s
        z = (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        w = (r[0, 2] - r[2, 0]) / s
        x = (r[0, 1] + r[1, 0]) / s
        y = 0.25 * s
        z = (r[1, 2] + r[2, 1]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        w = (r[1, 0] - r[0, 1]) / s
        x = (r[0, 2] + r[2, 0]) / s
        y = (r[1, 2] + r[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def compute_mass_properties(
    points: np.ndarray,
    tets: np.ndarray,
    density: float,
    scale: np.ndarray | tuple = (1.0, 1.0, 1.0),
    length_to_si: float | None = None,
) -> MassProperties:
    """`scale` maps tet coordinates to node-local; `length_to_si` maps node-local lengths
    to meters (defaults to the mean of `scale`, as the reference does)."""
    points = np.asarray(points, dtype=np.float64)
    tets = np.asarray(tets, dtype=np.int64)
    scale = np.asarray(scale, dtype=np.float64)
    if length_to_si is None:
        length_to_si = float(np.mean(scale))
    pos = points / scale  # node-local

    v = pos[tets]  # (E, 4, 3)
    r = v[:, 1:] - v[:, :1]
    det = np.einsum("ei,ei->e", r[:, 0], np.cross(r[:, 1], r[:, 2]))
    quarter = np.abs(det) / 6.0 * 0.25  # per-corner lumped volume
    vol = np.zeros(points.shape[0])
    np.add.at(vol, tets.reshape(-1), np.repeat(quarter, 4))

    total = vol.sum()
    if total <= 0:
        return MassProperties()
    com = (vol[:, None] * pos).sum(axis=0) / total

    rvec = pos - com
    rr = np.einsum("ni,ni->n", rvec, rvec)
    inertia = np.zeros((3, 3))
    for i in range(3):
        inertia[i, i] = (vol * (rr - rvec[:, i] ** 2)).sum()
    for i, j in ((0, 1), (0, 2), (1, 2)):
        inertia[i, j] = inertia[j, i] = -(vol * rvec[:, i] * rvec[:, j]).sum()
    s = float(length_to_si)
    inertia *= density * s**5

    evals, evecs = np.linalg.eigh(inertia)
    if np.linalg.det(evecs) < 0:
        evecs = evecs.copy()
        evecs[:, 0] = -evecs[:, 0]  # proper rotation for the quaternion

    return MassProperties(
        mass=float(density * total * s**3),
        center_of_mass=com.astype(np.float64),
        inertia_diagonal=evals.astype(np.float64),
        inertia_orientation=_quat_from_matrix(evecs),
    )
