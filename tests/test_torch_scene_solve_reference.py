"""The reference that holds the scene's reconcile (portbench/reference/sparse_fem.py, and
reference/scene.py's mass properties) against the references the solve cells use and
against the port: on the falling scene's two body kinds at a small size, the sparse
route's modal model equals the dense one of reference/fem.py, and the lumped mass
properties equal the port's."""

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch.fem.mass_properties import compute_mass_properties
from mesheditor_tpu_torch.mesh import grid_box_surface, icosphere_surface
from portbench.reference import compare, fem, mesher, sparse_fem
from portbench.reference import scene as ref_scene

torch.set_num_threads(2)
PLASTIC = dict(density=1070.0, young=1.4e9, poisson=0.35, alpha=30.0, beta=1e-6)
WOOD = dict(density=750.0, young=1.1e10, poisson=0.25, alpha=60.0, beta=2e-6)


def _body(kind: str):
    """(tet points, tets, surface points, material) of a small ball or block."""
    if kind == "ball":
        pts, tris = icosphere_surface(2)
        pts, mat = pts * 0.05, PLASTIC
    else:
        pts, tris = grid_box_surface(3)
        pts, mat = (pts - 0.5) * 2.0 * np.array([0.08, 0.02, 0.05]), WOOD
    span = float((pts.max(0) - pts.min(0)).max())
    tet_pts, tets = mesher.delaunay(pts, tris, span / 6)
    return tet_pts, tets, pts, mat


@pytest.mark.parametrize("kind", ["ball", "block"])
def test_the_sparse_route_answers_as_the_dense_one(kind):
    tet_pts, tets, pts, mat = _body(kind)
    excite = pts[np.linspace(0, len(pts) - 1, 10).astype(int)]
    args = (tet_pts, tets, mat, excite, 30, 45, 20.0, 16000.0)
    sparse = sparse_fem.solve_modes(*args)
    dense = fem.solve_modes(*args)
    assert sparse_fem.lowest_pairs.last["residual"] < 1e-8  # its tolerance
    assert sparse["dofs"] == dense["dofs"]
    assert len(sparse["freqs"]) == len(dense["freqs"]) > 5
    assert compare.freq_rel(sparse, dense) < 1e-8
    n = len(dense["freqs"])
    assert np.abs(sparse["t60s"] - dense["t60s"]).max() / dense["t60s"].max() < 1e-7
    assert compare.gain_rel(sparse["shapes"], dense["shapes"], dense["freqs"][:n]) < 1e-3


@pytest.mark.parametrize("kind", ["ball", "block"])
def test_the_lumped_mass_properties_are_the_ports(kind):
    tet_pts, tets, _pts, mat = _body(kind)
    kept = fem.keep_elements(tet_pts, tets)
    ref = ref_scene.mass_properties(tet_pts, kept, mat["density"])
    got = compute_mass_properties(tet_pts, kept, mat["density"])
    w, x, y, z = got.inertia_orientation
    r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    inertia = r @ np.diag(got.inertia_diagonal) @ r.T
    assert abs(got.mass - ref["mass"]) <= 1e-12 * ref["mass"]
    assert np.abs(got.center_of_mass - ref["center_of_mass"]).max() <= 1e-12
    assert np.abs(inertia - ref["inertia"]).max() <= 1e-10 * np.abs(ref["inertia"]).max()
    assert np.allclose(np.linalg.inv(ref["inertia"]), ref_scene.inverse_inertia(ref))
