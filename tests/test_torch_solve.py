"""Port eigensolve (mesheditor_tpu_torch/solve) against the JAX package's mesh2modes on
the same bar. The port's float64 device engine (small_n=0) is held to the reference's
EXACT host shift-invert path (default small_n), not to the reference's small_n=0 engine,
which carries the pad-slot preconditioner fault (ROADMAP, Queue 3)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
from mesheditor_tpu import mesh2modes as jax_mesh2modes
from mesheditor_tpu.fem import assembly as jax_assembly
from mesheditor_tpu.fem.quad_mesh import build_quad_mesh as jax_build_quad_mesh
from mesheditor_tpu.solve.lobpcg import _small_pencil_path as jax_small_pencil_path

from mesheditor_tpu_torch import SolverConfig, mesh2modes
from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                      filter_degenerate, pencil_diagonals)
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import bar_tets
from mesheditor_tpu_torch.solve import lobpcg
from mesheditor_tpu_torch.solve.amg import build_amg

CFG = SolverConfig(tolerance=1e-8)
SIGMA = -((2 * np.pi * CFG.min_mode_freq) ** 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bar():
    mesh = bar_tets(0.2, 0.06, 0.05, 7, 3, 3)
    excite = mesh.points[::20][:5]
    return mesh, excite


@pytest.fixture(scope="module")
def reference(bar):
    mesh, excite = bar
    return jax_mesh2modes(mesh, CERAMIC.properties, excite, config=CFG)


@pytest.fixture(scope="module")
def engine(bar):
    """The port's device engine on the bar, with its counters observed."""
    mesh, excite = bar
    before = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
    result = mesh2modes(mesh, CERAMIC.properties, excite, config=replace(CFG, small_n=0),
                        device="cpu")
    return result, (lobpcg.DEVICE_SOLVES - before[0], lobpcg.HOST_SOLVES - before[1])


def test_engine_eigenvalues_match_exact_reference(engine, reference):
    result, counts = engine
    assert counts == (1, 0)
    assert result.profile.dofs == reference.profile.dofs
    got, ref = result.summary.eigenvalues, reference.summary.eigenvalues
    assert got.shape == ref.shape
    # Rigid modes: exact zeros from the engine; the host path's are roundoff-small.
    assert np.all(got[:6] == 0.0) and np.all(ref[:6] < 1e-6 * ref[6])
    assert np.abs(got[6:] / ref[6:] - 1).max() < 1e-6


def test_engine_modes_match_reference(engine, reference):
    result, _ = engine
    got, ref = result.modes, reference.modes
    assert got.num_modes == ref.num_modes
    assert np.abs(got.freqs / ref.freqs - 1).max() < 1e-6
    assert np.abs(got.t60s / ref.t60s - 1).max() < 1e-6
    assert np.array_equal(result.sample_point_of_excitation, reference.sample_point_of_excitation)


def _clusters(lam, rel=1e-4):
    groups, start = [], 0
    for i in range(1, lam.size + 1):
        if i == lam.size or abs(lam[i] - lam[i - 1]) > rel * abs(lam[i]):
            groups.append((start, i))
            start = i
    return groups


def test_engine_eigenvectors_span_reference_subspaces(bar):
    """Port engine eigenvectors against the reference's exact host eigenvectors, compared
    as M-subspaces per cluster (signs and degenerate rotations are free)."""
    mesh, _ = bar
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, CERAMIC.properties, quad)
    k_diag, m_diag = pencil_diagonals(ops)
    pre = build_amg(mesh.points, kept, quad, ops, k_diag, m_diag, SIGMA)
    nev = 40
    res = lobpcg.lobpcg_pencil(ops, nev, sigma=SIGMA, precond=pre, tol=1e-8, small_n=0)
    jquad = jax_build_quad_mesh(kept, mesh.points.shape[0])
    jops = jax_assembly.assemble_element_matrices(mesh.points, kept, CERAMIC.properties, jquad)
    ref = jax_small_pencil_path(jops, jops.n_dofs, nev, nev + 15, SIGMA, None)
    u = res.eigenvectors
    v = torch.tensor(np.asarray(ref.eigenvectors))
    mv = ops.mmat(v)
    assert (u.T @ ops.mmat(u) - torch.eye(nev, dtype=u.dtype)).abs().max() < 1e-10
    lam = ref.eigenvalues
    for a, b in _clusters(lam):
        if a < 6:
            a = 0  # the rigid block is one 6-dimensional subspace
            if b <= 6:
                continue
        cos = torch.linalg.svdvals(u[:, a:b].T @ mv[:, a:b])
        sin_max = float(torch.sqrt(torch.clamp(1 - cos.min() ** 2, min=0.0)))
        assert sin_max < 1e-3, (a, b, sin_max)
    assert np.abs(res.eigenvalues[6:] / lam[6:] - 1).max() < 1e-6


@pytest.fixture(scope="module")
def dense_oracle(bar):
    """Lowest 45 eigenvalues of the assembled pencil by dense LAPACK (independent of ARPACK)."""
    import scipy.linalg as sla

    from mesheditor_tpu_torch.solve.lobpcg import _pencil_csr

    mesh, _ = bar
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    k, m = _pencil_csr(assemble_element_matrices(mesh.points, kept, CERAMIC.properties, quad))
    return sla.eigh(k.toarray(), m.toarray(), eigvals_only=True, subset_by_index=[0, 44])


def test_small_pencil_path_matches_reference(bar, reference, dense_oracle):
    """The port's host path is the reference's (scipy shift-invert Lanczos on the same CSR
    pencil). ARPACK's answers move between calls on this pencil (its random start and an
    ill-conditioned shift-invert solve: measured up to 4e-9 from dense LAPACK for either
    package, and 1.04e-8 between the two packages' calls), so the bound is 5e-8."""
    mesh, excite = bar
    before = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
    result = mesh2modes(mesh, CERAMIC.properties, excite, config=CFG, device="cpu")
    assert (lobpcg.DEVICE_SOLVES - before[0], lobpcg.HOST_SOLVES - before[1]) == (0, 1)
    got, ref = result.summary.eigenvalues, reference.summary.eigenvalues
    assert np.abs(got[6:] / ref[6:] - 1).max() < 5e-8
    assert np.abs(got[6:] / dense_oracle[6:] - 1).max() < 5e-8
    assert np.abs(got[:6]).max() < 1e-6 * ref[6]


def test_engine_eigenvalues_match_dense_oracle(engine, dense_oracle):
    result, _ = engine
    got = result.summary.eigenvalues
    assert np.abs(got[6:] / dense_oracle[6:] - 1).max() < 1e-7


def test_without_amg_the_host_answers_and_is_counted(bar, reference):
    mesh, excite = bar
    before = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
    result = mesh2modes(mesh, CERAMIC.properties, excite,
                        config=replace(CFG, small_n=0, use_amg=False), device="cpu")
    assert (lobpcg.DEVICE_SOLVES - before[0], lobpcg.HOST_SOLVES - before[1]) == (0, 1)
    assert np.abs(result.modes.freqs / reference.modes.freqs - 1).max() < 1e-6


def test_cancellation_gives_an_empty_result(bar):
    mesh, excite = bar
    before = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
    calls = []

    def cancelled():
        calls.append(1)
        return len(calls) > 1  # let the assembly through, cancel inside the iteration

    result = mesh2modes(mesh, CERAMIC.properties, excite, config=replace(CFG, small_n=0),
                        cancelled=cancelled, device="cpu")
    assert result.modes.num_modes == 0
    assert (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES) == before


def test_warm_start_reconverges(bar, engine):
    mesh, excite = bar
    result, _ = engine
    from mesheditor_tpu_torch import SolveReuse

    first = mesh2modes(mesh, CERAMIC.properties, excite, config=replace(CFG, small_n=0),
                       reuse=SolveReuse(keep_basis=True), device="cpu")
    warm = mesh2modes(mesh, CERAMIC.properties, excite, config=replace(CFG, small_n=0),
                      reuse=SolveReuse(seed_basis=first.basis), device="cpu")
    assert warm.profile.restarts <= first.profile.restarts
    assert np.abs(warm.modes.freqs / result.modes.freqs - 1).max() < 1e-4
