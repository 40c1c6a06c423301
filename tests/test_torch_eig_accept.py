"""The port's device engine answers by the reference's f64 polish acceptance rules
(mesheditor_tpu/solve/lobpcg.py:653,695-724): every pair settled at `tolerance` two
iterations running, or, when the iteration budget is spent, every pair moving less than
max(tolerance, tol_accept). Anything else goes to the host shift-invert when the pencil is
host-feasible, and gives the empty result when it is not.

On a small bar above a lowered small_n (2,205 dofs), at tolerance 1e-14 and a budget of 8
iterations, the values move ~1e-9 relative by the last iteration: under the default
tol_accept (1e-4), so the device answers; over a tol_accept equal to the tolerance, so the
host answers. The answers are held to the reference's exact host path on the same pencil
(its `_small_pencil_path`), not to the reference's small_n=0 engine, which carries the
pad-slot preconditioner fault (ROADMAP, Queue 3). The polish's third rule, the stagnation
exit, is not ported (solve/eigs.py says why).
"""

import contextlib
import io
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

NEV = 45
TOL = 1e-14
BUDGET = 8  # the iteration of the last line: 28 of 39 elastic pairs settled, all under 1e-4
CFG = SolverConfig(num_modes=30, num_fem_modes=NEV, tolerance=TOL, max_restarts=BUDGET,
                   small_n=0)
SIGMA = -((2 * np.pi * CFG.min_mode_freq) ** 2)
PARITY = 1e-3  # frequencies against the reference's host path (the thin shells' bar)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bar():
    mesh = bar_tets(0.2, 0.06, 0.05, 7, 3, 3)
    return mesh, mesh.points[::20][:5]


@pytest.fixture(scope="module")
def pencil(bar):
    """The bar's element operators and AMG, and the reference's exact host eigenvalues of
    the same pencil."""
    mesh, _ = bar
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, CERAMIC.properties, quad, device="cpu")
    pre = build_amg(mesh.points, kept, quad, ops, *pencil_diagonals(ops), SIGMA)
    jquad = jax_build_quad_mesh(kept, mesh.points.shape[0])
    jops = jax_assembly.assemble_element_matrices(mesh.points, kept, CERAMIC.properties, jquad)
    ref = jax_small_pencil_path(jops, jops.n_dofs, NEV, NEV + 15, SIGMA, None)
    return ops, pre, np.asarray(ref.eigenvalues)


@pytest.fixture(scope="module")
def reference(bar):
    """The reference's mesh2modes on the bar at its default small_n: its exact host path."""
    mesh, excite = bar
    return jax_mesh2modes(mesh, CERAMIC.properties, excite, config=replace(CFG, small_n=9000))


def counts():
    return (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES, dict(lobpcg.DEVICE_EXITS))


def moved(before):
    """(device solves, host solves, {exit: device answers}) since `before` (counts())."""
    d, h, exits = before
    return (lobpcg.DEVICE_SOLVES - d, lobpcg.HOST_SOLVES - h,
            {k: v - exits[k] for k, v in lobpcg.DEVICE_EXITS.items() if v - exits[k]})


def freq_rel(lam, ref):
    """Largest relative frequency difference over the elastic pairs."""
    return float(np.abs(np.sqrt(lam[6:] / ref[6:]) - 1).max())


def solve_pencil(pencil, debug=False, **kw):
    """lobpcg_pencil on the bar at CFG's tolerance, budget and inner count (keywords
    override). Returns (result, what it moved, stdout lines)."""
    ops, pre, _ = pencil
    args = dict(tol=TOL, max_iters=BUDGET, inner_iters=CFG.inner_iters, small_n=0) | kw
    before = counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = lobpcg.lobpcg_pencil(ops, NEV, sigma=SIGMA, precond=pre, debug=debug, **args)
    return res, moved(before), buf.getvalue().splitlines()


def solve_mesh(bar, **kw):
    """mesh2modes on the bar at CFG (fields overridden by keywords). Returns (result, what
    it moved)."""
    mesh, excite = bar
    before = counts()
    res = mesh2modes(mesh, CERAMIC.properties, excite, config=replace(CFG, **kw), device="cpu")
    return res, moved(before)


def test_budget_spent_under_tol_accept_the_device_answers(pencil):
    """The default tol_accept: the engine answers at its last iteration by the budget rule,
    counted as a device solve, within the bar of the reference's host answer; its trace's
    exit line names the rule."""
    _, _, ref = pencil
    res, moved_, lines = solve_pencil(pencil, debug=True)
    assert moved_ == (1, 0, {"budget": 1})
    assert res.iterations == BUDGET and res.eigenvalues.size == NEV
    assert np.all(res.eigenvalues[:6] == 0.0)
    assert freq_rel(res.eigenvalues, ref) < PARITY
    assert lines[-1].startswith(f"[ortho exit] it={BUDGET} exit=budget settled=28/39 "
                                f"accepted=39/39 "), lines[-1]
    assert len(lines) == BUDGET + 1


def test_tol_accept_at_the_tolerance_sends_the_budget_to_the_host(pencil):
    """tol_accept equal to the tolerance: no rule answers, so the host does, with the
    reference's host answer (ARPACK's 5e-8, tests/test_torch_solve.py); the trace ends on a
    `noconv` exit line."""
    _, _, ref = pencil
    res, moved_, lines = solve_pencil(pencil, debug=True, tol_accept=TOL)
    assert moved_ == (0, 1, {})
    assert res.iterations == BUDGET + 1 and res.eigenvalues.size == NEV
    assert np.abs(res.eigenvalues[6:] / ref[6:] - 1).max() < 5e-8
    assert lines[-1].startswith(f"[ortho exit] it={BUDGET} exit=noconv "), lines[-1]


@pytest.mark.parametrize("tol_accept, answers", [(1e-4, True), (TOL, False)])
def test_without_host_fallback_the_budget_rule_decides(pencil, tol_accept, answers):
    """host_fallback_n=0: the budget rule's answer where it holds, else the empty result,
    and nothing on the host either way."""
    res, moved_, _ = solve_pencil(pencil, tol_accept=tol_accept, host_fallback_n=0)
    assert moved_ == ((1, 0, {"budget": 1}) if answers else (0, 0, {}))
    assert res.eigenvalues.size == (NEV if answers else 0)
    assert res.eigenvectors.shape == (pencil[0].n_dofs, NEV if answers else 0)


def test_a_settled_solve_keeps_its_exit(pencil):
    """With a budget it does not reach, the solve answers by the settled rule as before,
    at the reference host answer's engine parity (1e-6, tests/test_torch_solve.py)."""
    _, _, ref = pencil
    res, moved_, _ = solve_pencil(pencil, max_iters=100)
    assert moved_ == (1, 0, {"settled": 1})
    assert res.iterations < 100
    assert np.abs(res.eigenvalues[6:] / ref[6:] - 1).max() < 1e-6


@pytest.mark.parametrize("tol_accept, host_fallback_n, path", [
    (1e-4, 120_000, "device"), (TOL, 120_000, "host"),
    (1e-4, 0, "device"), (TOL, 0, "none")])
def test_mesh2modes_threads_tol_accept(bar, reference, tol_accept, host_fallback_n, path):
    """The same four cases through mesh2modes(SolverConfig(tol_accept=...)). SolverConfig
    clamps tol_accept to 1e-12 at least, still far under the last iteration's moves."""
    res, moved_ = solve_mesh(bar, tol_accept=tol_accept, host_fallback_n=host_fallback_n)
    assert moved_ == {"device": (1, 0, {"budget": 1}), "host": (0, 1, {}),
                      "none": (0, 0, {})}[path]
    if path == "none":
        assert res.modes.num_modes == 0
        return
    assert res.modes.num_modes == reference.modes.num_modes > 0
    assert freq_rel(res.summary.eigenvalues, reference.summary.eigenvalues) < PARITY
    assert np.abs(res.modes.freqs / reference.modes.freqs - 1).max() < PARITY


@pytest.mark.parametrize("at", [3, BUDGET])
def test_cancellation_gives_the_empty_result(pencil, at):
    """A callback that cancels at iteration `at` gives the empty result, also at the last
    iteration, where the budget rule would have answered; nothing is counted."""
    res, moved_, _ = solve_pencil(pencil, callback=lambda it, settled: it >= at)
    assert moved_ == (0, 0, {})
    assert res.eigenvalues.size == 0 and res.iterations == at
