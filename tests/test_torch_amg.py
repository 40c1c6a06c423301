"""Port AMG preconditioner (mesheditor_tpu_torch/solve/amg.py) against the JAX package's
build_amg on the same bar: the host structure is identical, the float64 coarse pencil is
exactly Galerkin, the rigid basis is M-orthonormal, the damping matches."""

import dataclasses

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from mesheditor_tpu.fem import assembly as jax_assembly
from mesheditor_tpu.fem.quad_mesh import build_quad_mesh as jax_build_quad_mesh
from mesheditor_tpu.solve import amg as jax_amg

from mesheditor_tpu_torch import convert
from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                      filter_degenerate, pencil_diagonals)
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import bar_tets
from mesheditor_tpu_torch.solve import amg
from mesheditor_tpu_torch.solve.lobpcg import _pencil_csr

SIGMA = -((2 * np.pi * 20.0) ** 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    mesh = bar_tets(0.2, 0.06, 0.05, 7, 3, 3)
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, CERAMIC.properties, quad, device="cpu")
    k_diag, m_diag = pencil_diagonals(ops)
    pre = amg.build_amg(mesh.points, kept, quad, ops, k_diag, m_diag, SIGMA)
    jquad = jax_build_quad_mesh(kept, mesh.points.shape[0])
    jops = jax_assembly.assemble_element_matrices(mesh.points, kept, CERAMIC.properties, jquad)
    jkd, jmd = jax_assembly.pencil_diagonals(jops)
    jpre = jax_amg.build_amg(mesh.points, kept, jquad, jops, jkd, jmd, SIGMA)
    return mesh, kept, quad, ops, pre, jops, jpre


def dense_prolongator(pre, n_dofs):
    w = pre.w.numpy()
    agg = pre.agg.numpy()
    p = np.zeros((n_dofs, 6 * pre.nagg))
    for node in range(w.shape[0]):
        for c in range(3):
            p[3 * node + c, 6 * agg[node] : 6 * agg[node] + 6] += w[node, c]
    return p


@pytest.mark.parametrize("max_aggs", [682, 12])
def test_host_structure_identical(setup, max_aggs):
    mesh, kept, quad, *_ = setup
    en = quad.element_nodes
    agg, nagg = amg._aggregate(en, quad.node_count, max_aggs)
    jagg, jnagg = jax_amg._aggregate(en, quad.node_count, max_aggs)
    assert nagg == jnagg and np.array_equal(agg, jagg)
    coords = amg._quad_node_coords(mesh.points, kept, quad.node_count)
    assert np.array_equal(coords, jax_amg._quad_node_coords(mesh.points, kept, quad.node_count))
    w = amg._rigid_weights(coords, np.clip(agg, 0, None), nagg)
    assert np.array_equal(w, jax_amg._rigid_weights(coords, np.clip(jagg, 0, None), jnagg))
    comp, ncomp = amg._components(en, quad.node_count)
    jcomp, jncomp = jax_amg._components(en, quad.node_count)
    assert ncomp == jncomp == 1 and np.array_equal(comp, jcomp)


def test_aggregation_matches_reference_precond(setup):
    *_, pre, _jops, jpre = setup
    assert pre.nagg == jpre.nagg
    assert np.array_equal(pre.agg.numpy(), np.asarray(jpre.agg6)[:, 0] // 6)


def test_coarse_pencil_is_exact_galerkin(setup):
    *_, ops, pre, _jops, _jpre = setup
    k, m = _pencil_csr(ops)
    p = dense_prolongator(pre, ops.n_dofs)
    w_d = pre.w
    kc, mc = amg._coarse_assemble_pencil(ops, w_d, pre.agg, pre.nagg)
    for port, ref in ((kc, p.T @ k.toarray() @ p), (mc, p.T @ m.toarray() @ p)):
        assert np.abs(port.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    assert torch.equal(mc, pre.mc)


def test_coarse_pencil_matches_reference(setup):
    *_, ops, pre, jops, jpre = setup
    kc, mc = amg._coarse_assemble_pencil(ops, pre.w, pre.agg, pre.nagg)
    # The reference's pair-block Galerkin, run in float64: the same algorithm.
    mb = jops.rho_vol[:, None, None] * jops.m_unit[None]
    en = jops.elem_dofs[:, ::3] // 3
    agg = jpre.agg6[:, 0] // 6
    jk64, jm64 = jax_amg._pair_block_galerkin(
        jnp.stack([jops.k_blocks, mb]), en, jnp.asarray(pre.w.numpy()), agg, jpre.nagg)
    for port, ref in ((kc, jk64), (mc, jm64)):
        ref = np.asarray(ref)
        assert np.abs(port.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    # The reference's production pencil rounds the blocks and the prolongator to float32
    # and accumulates in float32 (amg.py:425-438, 701-709): ~1e-5 of the largest entry.
    jkc, jmc = jax_amg._coarse_assemble_pencil(
        jops.k_blocks, jops.rho_vol, jops.m_unit, en, jnp.asarray(jpre.w, jnp.float64),
        jpre.agg6, jpre.nagg)
    for port, ref in ((kc, jkc), (mc, jmc)):
        ref = np.asarray(ref)
        assert np.abs(port.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_rigid_basis(setup):
    mesh, kept, quad, ops, pre, *_ = setup
    r = pre.rigid
    assert r.shape == (ops.n_dofs, 6)
    torch.testing.assert_close(pre.m_rigid, ops.mmat(r), rtol=0, atol=1e-12 * pre.m_rigid.abs().max())
    g = (r.T @ ops.mmat(r)).numpy()
    assert np.abs(g - np.eye(6)).max() < 1e-10
    # Same span as the host construction, and annihilated by K.
    coords = amg._quad_node_coords(mesh.points, kept, quad.node_count)
    comp, ncomp = amg._components(quad.element_nodes, quad.node_count)
    host = amg.rigid_modes(coords, comp, ncomp, ops.n_dofs)
    dev = amg._rigid_modes_device(torch.as_tensor(coords), torch.as_tensor(comp), ncomp)
    assert np.abs(dev.numpy() - host).max() < 1e-14
    kr = ops.kmat(r)
    assert kr.abs().max() <= 1e-9 * ops.k_blocks.abs().max() * r.abs().max()


def test_omega_close_to_reference(setup):
    """Smoother damping within 5% of the reference's power iteration (different random
    numbers) on the ELEMENT-form shifted operator. The reference's production omega runs
    on the macro-element bf16 operator, whose pad-slot diagonal bump inflates the Jacobi
    radius (ROADMAP, Queue 3); the port is held to the element form."""
    *_, pre, jops, jpre = setup
    elem_ops = dataclasses.replace(jops, macro_nodes=None, macro_km=None, elem_macro=None,
                                   elem_slot=None)
    shifted = jax_assembly.bake_shifted_f32(elem_ops, SIGMA)
    rho = float(jax_amg._dinv_a_radius(shifted, jpre.inv_diag, 4))
    ref = 1.0 / (1.05 * max(rho, 1.0))
    assert abs(pre.omega - ref) <= 0.05 * ref
    assert pre.sa == 0.0 and jpre.sa == 0.0  # a uniform bar: plain aggregation


def test_coarse_inverse(setup):
    *_, ops, pre, _jops, _jpre = setup
    kc, mc = amg._coarse_assemble_pencil(ops, pre.w, pre.agg, pre.nagg)
    lifted = amg._lift_rigid(kc - SIGMA * mc, amg._restrict(pre.w, pre.agg, pre.nagg, pre.rigid))
    assert torch.equal(pre.ac_inv, pre.ac_inv.T)
    # The inverse is of the lifted operator with dead coarse dofs parked at the matrix
    # scale and a 1e-12 relative nudge on the live diagonal.
    a = 0.5 * (lifted + lifted.T).numpy()
    dg = np.diagonal(a)
    a = a + np.diag(np.where(dg <= 1e-9 * dg.max(), dg.max(), 1e-12 * dg))
    prod = pre.ac_inv.numpy() @ a
    assert np.abs(prod - np.eye(prod.shape[0])).max() < 1e-8


def test_apply_is_symmetric_and_deflated(setup):
    *_, ops, pre, _jops, _jpre = setup
    amat = ops.shifted(SIGMA).amat
    g = torch.Generator().manual_seed(3)
    r1, r2 = (torch.randn(ops.n_dofs, 2, dtype=torch.float64, generator=g) for _ in range(2))
    a = (r1 * pre.apply(amat, r2)).sum()
    b = (r2 * pre.apply(amat, r1)).sum()
    assert abs(float(a - b)) <= 1e-10 * abs(float(a))
    e = pre._coarse_correct(r1)
    assert (pre.m_rigid.T @ e).abs().max() <= 1e-10 * e.abs().max() * pre.m_rigid.abs().max()


def test_spectral_seed_matches_reference(setup):
    """Both seeds converge to the same coarse Ritz vectors (from different random
    starts), so their Rayleigh-Ritz values on the fine pencil agree."""
    *_, ops, pre, _jops, jpre = setup
    seed = amg.spectral_seed(pre, 12, generator=torch.Generator().manual_seed(20260710))
    assert seed.shape == (ops.n_dofs, 12)
    assert (pre.m_rigid.T @ seed).abs().max() <= 1e-10 * seed.abs().max() * pre.m_rigid.abs().max()
    jseed = torch.as_tensor(np.asarray(jax_amg.spectral_seed(jpre, 12, iters=20), np.float64))

    def ritz(x):
        return sla.eigh((x.T @ ops.kmat(x)).numpy(), (x.T @ ops.mmat(x)).numpy(),
                        eigvals_only=True)[:6]

    assert np.abs(ritz(seed) / ritz(jseed) - 1).max() < 1e-4


def test_convert_reference_precond(setup):
    *_, ops, pre, _jops, jpre = setup
    cpre = convert.amg_precond(
        agg6=np.asarray(jpre.agg6), w=np.asarray(jpre.w), ac_inv=np.asarray(jpre.ac_inv),
        inv_diag=np.asarray(jpre.inv_diag), rigid=np.asarray(jpre.rigid),
        m_rigid=np.asarray(jpre.m_rigid), mc=np.asarray(jpre.mc), omega=jpre.omega,
        nagg=jpre.nagg, sa=jpre.sa)
    assert torch.equal(cpre.agg, pre.agg)
    x = torch.as_tensor(np.random.default_rng(9).standard_normal((ops.n_dofs, 3)))
    # Same prolongator up to the reference's float32 weights.
    assert (cpre.restrict(x) - pre.restrict(x)).abs().max() <= 1e-6 * pre.restrict(x).abs().max()
