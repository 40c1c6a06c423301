"""Rigid-body mass properties of a closed triangle mesh.

Signed-tetrahedron decomposition about the origin (the classic polyhedral mass
integral): each face (v0, v1, v2) contributes the tetrahedron (0, v0, v1, v2) with
signed volume det/6; second moments use the exact tetrahedral integral
∫ x_i x_j dV = V/20 (Σ_k p_k p_k^T + s s^T), s = Σ_k p_k. The role the reference's
Jolt shape mass properties play for dynamic bodies (PhysicsSystem body setup)."""

from __future__ import annotations

import numpy as np


def mesh_mass_properties(positions, triangles, density: float = 1000.0):
    """(mass, center_of_mass, inertia_about_com) of a consistently outward-wound
    closed mesh. Negative or zero enclosed volume raises."""
    p = np.asarray(positions, np.float64)
    t = np.asarray(triangles, np.int64)
    a, b, c = p[t[:, 0]], p[t[:, 1]], p[t[:, 2]]
    vols = np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0  # signed tet volumes
    volume = float(vols.sum())
    if volume <= 0:
        raise ValueError(f"mesh encloses non-positive volume {volume}")

    com = (vols[:, None] * (a + b + c) / 4.0).sum(axis=0) / volume

    s = a + b + c
    # Second moment about the origin: sum over tets of V/20 (sum_k p_k p_k^T + s s^T).
    pk = (
        np.einsum("ij,ik->ijk", a, a)
        + np.einsum("ij,ik->ijk", b, b)
        + np.einsum("ij,ik->ijk", c, c)
        + np.einsum("ij,ik->ijk", s, s)
    )
    second = (vols[:, None, None] / 20.0 * pk).sum(axis=0)

    mass = density * volume
    # J_origin = rho * (tr(C) I - C); shift to the COM by the parallel-axis theorem.
    j_origin = density * (np.trace(second) * np.eye(3) - second)
    r = com
    j_com = j_origin - mass * ((r @ r) * np.eye(3) - np.outer(r, r))
    return mass, com, j_com
