"""The solver oracles of tests/test_modal_solver.py on the port's `mesh2modes(device="cpu")`,
at the same sizes and bars: the free-free square bar's mode families against their closed
forms (the reference's oracle, tests/ModalSolverTest.cpp:22-33: longitudinal, torsional
and Euler-Bernoulli bending), frequencies within 0.1% of scipy's shift-invert, and a warm
start that reconverges. The bar is also held to the JAX package's `mesh2modes` on the same
mesh, at 5e-8 where both answer on the host (ARPACK's spread between calls). The families
are sorted by tests/test_modal_solver.py's own classifier, and chip_smoke.py's copy of it
(which the card run uses) is held to it. The reference-resolution bar and the thin bar are
slow, as in the JAX file.
"""

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch import SolverConfig, mesh2modes
from mesheditor_tpu_torch.mesh import bar_tets
from mesheditor_tpu_torch.solve import lobpcg
from mesheditor_tpu_torch.solve.mesh2modes import SolveReuse
from mesheditor_tpu_torch.types import AcousticMaterialProperties

import chip_smoke
from test_modal_solver import BENDING_BL, check_family, classify

MATERIAL = AcousticMaterialProperties(1000, 1e7, 0.0)
SQUARE = (0.3, 0.05, 0.05)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def solve_bar(dims, res, material, num_fem_modes=30, num_modes=25):
    mesh = bar_tets(*dims, *res)
    cfg = SolverConfig(num_modes=num_modes, num_fem_modes=num_fem_modes, max_mode_freq=48000.0)
    result = mesh2modes(mesh, material, mesh.points, config=cfg, device="cpu")
    assert result.modes.num_modes > 0, "solve produced no modes"
    return mesh, cfg, result


@pytest.fixture(scope="module")
def small_bar():
    return solve_bar(SQUARE, (10, 2, 2), MATERIAL)


def _bending(fam):
    return sorted(fam.get("bending", []) + fam.get("bending_y", []) + fam.get("bending_z", []))


def test_square_bar_families_small(small_bar):
    """The coarse square bar: longitudinal (E/rho, assembly, eigensolve) within 2%, torsion
    (shear) within 8%, the degenerate bending pair within 12%."""
    _, _, result = small_bar
    fam = classify(result.modes, SQUARE, 10)
    speed = np.sqrt(MATERIAL.young_modulus / MATERIAL.density)
    f1_long = speed / (2 * SQUARE[0])
    check_family(sorted(fam.get("longitudinal", [])), [f1_long, 2 * f1_long], 0.02)
    f1_tor = np.sqrt(MATERIAL.lame_mu() / MATERIAL.density * 0.140577 * 6) / (2 * SQUARE[0])
    check_family(sorted(fam.get("torsional", [])), [f1_tor], 0.08)
    base = speed * SQUARE[2] / np.sqrt(12) / (2 * np.pi * SQUARE[0] ** 2)
    check_family(_bending(fam), [BENDING_BL[0] ** 2 * base] * 2, 0.12, min_count=2)


def test_chip_smoke_families_are_the_reference_tests(small_bar):
    """chip_smoke.py's classifier and closed forms (its phase n3) give what
    tests/test_modal_solver.py's give on the same modes."""
    _, _, result = small_bar
    assert chip_smoke.bar_families(result.modes, SQUARE, 10) == classify(result.modes,
                                                                           SQUARE, 10)
    assert chip_smoke.BENDING_BL == BENDING_BL
    theory = chip_smoke.bar_theory(SQUARE, MATERIAL)
    speed = np.sqrt(MATERIAL.young_modulus / MATERIAL.density)
    np.testing.assert_allclose(theory["longitudinal"], speed / 0.6, rtol=1e-15)
    np.testing.assert_allclose(
        theory["torsional"],
        np.sqrt(MATERIAL.lame_mu() / MATERIAL.density * 0.140577 * 6) / 0.6, rtol=1e-15)


def test_bar_matches_the_reference_package(small_bar):
    """The same bar through the JAX package's mesh2modes: both answer on the host (the
    pencil is under small_n), the elastic eigenvalues and the audible model's frequencies
    within 5e-8."""
    import mesheditor_tpu

    mesh, cfg, result = small_bar
    ref_cfg = mesheditor_tpu.SolverConfig(num_modes=cfg.num_modes,
                                          num_fem_modes=cfg.num_fem_modes,
                                          max_mode_freq=cfg.max_mode_freq)
    ref = mesheditor_tpu.mesh2modes(mesh, MATERIAL, mesh.points, config=ref_cfg)
    assert result.profile.dofs == ref.profile.dofs <= cfg.small_n
    got, want = result.summary.eigenvalues, np.asarray(ref.summary.eigenvalues)
    elastic = want > 1.0
    np.testing.assert_allclose(got[elastic], want[elastic], rtol=5e-8)
    assert result.modes.num_modes == ref.modes.num_modes
    np.testing.assert_allclose(result.modes.freqs, ref.modes.freqs, rtol=5e-8)


def test_frequencies_match_shift_invert():
    """The BASELINE parity bar: the undamped frequencies within 0.1% of scipy's sparse
    shift-invert on the same assembled pencil."""
    import scipy.sparse.linalg as spla

    from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                          filter_degenerate)

    mat = AcousticMaterialProperties(2700, 7.2e10, 0.19, 6, 1e-7)  # ceramic
    mesh = bar_tets(0.2, 0.04, 0.03, 6, 2, 2)
    cfg = SolverConfig(num_modes=20, num_fem_modes=20)
    result = mesh2modes(mesh, mat, mesh.points[:5], config=cfg, device="cpu")

    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, mat, quad, device="cpu")
    k, m = lobpcg._pencil_csr(ops)
    sigma = -((2 * np.pi * cfg.min_mode_freq) ** 2)
    evals = np.sort(spla.eigsh(k, k=20, M=m, sigma=sigma, which="LM",
                               return_eigenvectors=False))
    ref_freqs = np.sqrt(np.maximum(evals, 0)) / (2 * np.pi)
    ref_audible = ref_freqs[(ref_freqs >= cfg.min_mode_freq) & (ref_freqs <= cfg.max_mode_freq)]
    got_undamped = np.sqrt(result.summary.eigenvalues) / (2 * np.pi)
    got_audible = got_undamped[got_undamped >= cfg.min_mode_freq][: len(ref_audible)]
    rel = np.abs(got_audible - ref_audible) / ref_audible
    assert rel.max() < 1e-3, f"parity gate failed: max rel {rel.max():.2e}"
    assert result.modes.num_modes > 0


def test_warm_start_reconverges_fast():
    """A solve seeded with the basis of a solve of the same mesh in a slightly different
    material reconverges in fewer restarts, at frequencies shifted by about sqrt(E ratio)."""
    mesh = bar_tets(0.2, 0.04, 0.04, 5, 2, 2)
    cfg = SolverConfig(num_modes=15, num_fem_modes=15)
    cold = mesh2modes(mesh, MATERIAL, mesh.points[:4], config=cfg,
                      reuse=SolveReuse(keep_basis=True), device="cpu")
    assert cold.basis is not None
    mat2 = AcousticMaterialProperties(1000, 1.1e7, 0.02)  # Poisson changed: no exact rescale
    warm = mesh2modes(mesh, mat2, mesh.points[:4], config=cfg,
                      reuse=SolveReuse(seed_basis=cold.basis), device="cpu")
    assert warm.modes.num_modes > 0
    assert warm.profile.restarts < max(cold.profile.restarts, 4)
    ratio = warm.modes.freqs[0] / cold.modes.freqs[0]
    assert 0.95 < ratio / np.sqrt(1.1) < 1.05


@pytest.mark.slow
def test_square_bar_reference_resolution():
    """The reference's own case, 20x4x4: longitudinal 1%, torsional 5%, bending 10%
    (tests/ModalSolverTest.cpp:227-243)."""
    res = (20, 4, 4)
    _, _, result = solve_bar(SQUARE, res, MATERIAL, num_fem_modes=45, num_modes=30)
    fam = classify(result.modes, SQUARE, res[0])
    speed = np.sqrt(MATERIAL.young_modulus / MATERIAL.density)
    f1 = speed / (2 * SQUARE[0])
    check_family(sorted(fam.get("longitudinal", [])), [f1, 2 * f1, 3 * f1], 0.01, 2)
    f1_tor = np.sqrt(MATERIAL.lame_mu() / MATERIAL.density * 0.140577 * 6) / (2 * SQUARE[0])
    check_family(sorted(fam.get("torsional", [])), [f1_tor, 2 * f1_tor], 0.05, 2)
    base = speed * SQUARE[2] / np.sqrt(12) / (2 * np.pi * SQUARE[0] ** 2)
    check_family(_bending(fam)[:2], [BENDING_BL[0] ** 2 * base] * 2, 0.10, 2)


@pytest.mark.slow
def test_thin_bar_bending():
    """One quadratic element through the thickness still carries the bending strain
    (tests/ModalSolverTest.cpp:248-259)."""
    mat = AcousticMaterialProperties(1000, 1e9, 0.0)
    dims, res = (0.3, 0.05, 0.01), (30, 5, 1)
    _, _, result = solve_bar(dims, res, mat, num_fem_modes=45, num_modes=30)
    fam = classify(result.modes, dims, res[0])
    speed = np.sqrt(mat.young_modulus / mat.density)
    check_family(sorted(fam.get("longitudinal", [])), [speed / 0.6], 0.01)
    base = speed * dims[2] / np.sqrt(12) / (2 * np.pi * dims[0] ** 2)
    check_family(sorted(fam.get("bending_z", [])), [BENDING_BL[0] ** 2 * base], 0.05)
