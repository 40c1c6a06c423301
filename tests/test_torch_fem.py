"""Port element-form FEM (mesheditor_tpu_torch/fem/assembly.py) against the JAX package's
assemble_element_matrices on the same bar, plus the structural oracles of test_fem.py."""

import numpy as np
import pytest
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from mesheditor_tpu.fem import assembly as jax_assembly
from mesheditor_tpu.fem.quad_mesh import build_quad_mesh as jax_build_quad_mesh
from mesheditor_tpu.mesh import bar_tets as jax_bar_tets

from mesheditor_tpu_torch import convert
from mesheditor_tpu_torch.fem import (
    EDGE_CORNERS,
    assemble_element_matrices,
    build_quad_mesh,
    filter_degenerate,
    pencil_diagonals,
)
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import bar_tets
from mesheditor_tpu_torch.types import AcousticMaterialProperties

SIGMA = -((2 * np.pi * 20.0) ** 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["soft", "ceramic"])
def pair(request):
    """(mesh, quad, port ops, JAX ops) on bar_tets(0.3, 0.05, 0.05, 4, 2, 2)."""
    mat = (AcousticMaterialProperties(1000, 1e7, 0.0) if request.param == "soft"
           else CERAMIC.properties)
    mesh = bar_tets(0.3, 0.05, 0.05, 4, 2, 2)
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, mat, quad)
    jmesh = jax_bar_tets(0.3, 0.05, 0.05, 4, 2, 2)
    jkept = jax_assembly.filter_degenerate(jmesh.points, jmesh.tets)
    jquad = jax_build_quad_mesh(jkept, jmesh.points.shape[0])
    jops = jax_assembly.assemble_element_matrices(jmesh.points, jkept, mat, jquad)
    return mesh, quad, ops, jops


def dense(ops):
    k = np.zeros((ops.n_dofs, ops.n_dofs))
    m = np.zeros_like(k)
    dofs = ops.elem_dofs.numpy()
    kb = ops.k_blocks.numpy()
    mu = ops.m_unit.numpy()
    rv = ops.rho_vol.numpy()
    for e in range(dofs.shape[0]):
        ix = np.ix_(dofs[e], dofs[e])
        k[ix] += kb[e]
        m[ix] += rv[e] * mu
    return k, m


def test_mesh_inputs_match_reference(pair):
    mesh, quad, ops, jops = pair
    assert np.array_equal(ops.elem_dofs.numpy(), np.asarray(jops.elem_dofs))
    assert ops.n_dofs == jops.n_dofs


def test_k_blocks(pair):
    _, _, ops, jops = pair
    ref = np.asarray(jops.k_blocks)
    np.testing.assert_allclose(ops.k_blocks.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(ops.rho_vol.numpy(), np.asarray(jops.rho_vol), rtol=1e-12)


def test_kmat_mmat_panel(pair):
    _, _, ops, jops = pair
    x = np.random.default_rng(11).standard_normal((ops.n_dofs, 7))
    xt = torch.as_tensor(x)
    for port, ref in ((ops.kmat(xt), jops.kmat(jnp.asarray(x))),
                      (ops.mmat(xt), jops.mmat(jnp.asarray(x)))):
        ref = np.asarray(ref)
        assert np.abs(port.numpy() - ref).max() <= 1e-12 * np.linalg.norm(ref)


def test_single_vector_apply(pair):
    _, _, ops, _ = pair
    k, _ = dense(ops)
    x = np.random.default_rng(2).standard_normal(ops.n_dofs)
    kx = ops.kmat(torch.as_tensor(x)).numpy()
    assert np.abs(kx - k @ x).max() <= 1e-12 * np.linalg.norm(k @ x)


def test_diagonals_and_fixes(pair):
    _, _, ops, jops = pair
    kd, md = pencil_diagonals(ops)
    jkd, jmd = jax_assembly.pencil_diagonals(jops)
    for a, b in ((kd, jkd), (md, jmd), (ops.k_fix, jops.k_fix), (ops.m_fix, jops.m_fix)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-300)


def test_orphan_fixes_match_reference():
    """A point no tet touches gets parked dofs, scaled as the reference parks them."""
    mesh = bar_tets(0.3, 0.05, 0.05, 4, 2, 2)
    points = np.concatenate([mesh.points, [[1.0, 1.0, 1.0]]])
    kept = filter_degenerate(points, mesh.tets)
    quad = build_quad_mesh(kept, points.shape[0])
    ops = assemble_element_matrices(points, kept, CERAMIC.properties, quad)
    jquad = jax_build_quad_mesh(kept, points.shape[0])
    jops = jax_assembly.assemble_element_matrices(points, kept, CERAMIC.properties, jquad)
    assert (ops.k_fix.numpy() > 0).sum() == 3
    for a, b in ((ops.k_fix, jops.k_fix), (ops.m_fix, jops.m_fix)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()


def test_shifted_operator(pair):
    _, _, ops, _ = pair
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((ops.n_dofs, 3)))
    a = ops.shifted(SIGMA).amat(x)
    ref = ops.kmat(x) - SIGMA * ops.mmat(x)
    assert (a - ref).abs().max() <= 1e-12 * ref.norm()


def test_convert_from_reference_applies_the_same(pair):
    _, _, ops, jops = pair
    cops = convert.element_operators(
        elem_dofs=np.asarray(jops.elem_dofs), k_blocks=np.asarray(jops.k_blocks),
        rho_vol=np.asarray(jops.rho_vol), m_unit=np.asarray(jops.m_unit),
        k_fix=np.asarray(jops.k_fix), m_fix=np.asarray(jops.m_fix), n_dofs=jops.n_dofs)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((ops.n_dofs, 2)))
    assert torch.equal(cops.elem_nodes, ops.elem_nodes)
    ref = ops.kmat(x)
    assert (cops.kmat(x) - ref).abs().max() <= 1e-12 * ref.norm()


def test_symmetry_and_mass_total(pair):
    mesh, _, ops, _ = pair
    k, m = dense(ops)
    assert np.allclose(k, k.T, atol=1e-8 * np.abs(k).max())
    assert np.allclose(m, m.T, atol=1e-14 * np.abs(m).max())
    rho = float(ops.rho_vol.sum()) / (0.3 * 0.05 * 0.05)
    x_dofs = np.arange(0, ops.n_dofs, 3)
    total = m[np.ix_(x_dofs, x_dofs)].sum()
    assert abs(total - rho * 0.3 * 0.05 * 0.05) < 1e-9 * total


def test_rigid_modes_in_nullspace(pair):
    mesh, quad, ops, _ = pair
    pts = mesh.points
    en = ops.elem_nodes.numpy()
    coords = np.zeros((quad.node_count, 3))
    coords[: pts.shape[0]] = pts
    for e_idx, (i, j) in enumerate(EDGE_CORNERS):
        coords[en[:, 4 + e_idx]] = 0.5 * (pts[en[:, i]] + pts[en[:, j]])
    k, _ = dense(ops)
    scale = np.abs(k).max()
    for t in np.eye(3):
        u = np.tile(t, quad.node_count)
        assert np.abs(k @ u).max() < 1e-9 * scale
    for axis in np.eye(3):
        u = np.cross(np.broadcast_to(axis, coords.shape), coords).reshape(-1)
        assert np.abs(k @ u).max() < 1e-8 * scale * max(np.abs(u).max(), 1)


def test_stiffness_positive_semidefinite(pair):
    _, _, ops, _ = pair
    k, _ = dense(ops)
    w = np.linalg.eigvalsh(k)
    assert w.min() > -1e-8 * w.max()


def test_degenerate_filter_matches_reference():
    mesh = bar_tets(0.1, 0.1, 0.1, 2, 2, 2)
    pts = np.concatenate([mesh.points, mesh.points[:1]])
    tets = np.concatenate([mesh.tets, np.array([[0, 1, 2, 2]], dtype=np.uint32)])
    kept = filter_degenerate(pts, tets)
    assert kept.shape[0] == mesh.tets.shape[0]
    assert np.array_equal(kept, jax_assembly.filter_degenerate(pts, tets))
