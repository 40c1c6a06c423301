"""The device engine's exit rules (mesheditor_tpu_torch/solve/eigs.py:_ExitRules) held to
the reference's: the scripts of tests/test_eigs_engine.py::TestDriverExits run through the
reference's driver (its own `_FakeStages`, mesheditor_tpu/solve/eigs.py:ortho_lobpcg) and
through the port's exit object, one script row an iteration. The reference checks each row
one iteration behind, so an exit lands at most one iteration apart. Its "handoff" (its f32
stage handing the panel to its f64 polish) is the port's gate opening; the polish's
stagnation exit, which the gate would admit, is left out of the port (eigs.py says why).

Then the rest of the reference's engine cases on the port: soft locking on the bar, and
SolverConfig's clamp; and the certificate on a real pencil, against the host path.
"""

import numpy as np
import pytest
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
from mesheditor_tpu.solve import eigs as ref_eigs
from mesheditor_tpu.types import SolverConfig as RefSolverConfig
from test_eigs_engine import _run_driver

from mesheditor_tpu_torch import SolverConfig, mesh2modes
from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                      filter_degenerate, pencil_diagonals)
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import bar_tets
from mesheditor_tpu_torch.solve import eigs, lobpcg
from mesheditor_tpu_torch.solve.amg import build_amg

THETA = np.arange(1.0, 7.0)
NEV = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stuck_at_two(i, wobble=0.05):
    """Indices >= 2 move by `wobble` relative, up and down in turn: the prefix stays at 2."""
    t = THETA.copy()
    t[2:] *= 1 + wobble * (-1) ** i
    return t


def _converging(i):
    """Every value approaches its limit by 0.3x an iteration from 1e-3 relative: its moves
    are under 3e-7 from row 8 on, under 1e-8 from row 11 on."""
    return THETA * (1 + 1e-3 * 0.3 ** i)


# tests/test_eigs_engine.py::TestDriverExits, script for script (:193-243).
SCRIPTS = {
    "settled": dict(script=[(THETA, np.full(6, 0.5))] * 10),
    "certified": dict(script=[(THETA * (1 + 0.01 * i), np.full(6, 1e-5)) for i in range(20)]),
    "handoff": dict(script=[(_stuck_at_two(i), np.full(6, 0.3)) for i in range(60)],
                    max_iters=60),
    "nan": dict(script=[(np.full(6, np.nan), np.full(6, 0.5))] * 4),
    "cancel": dict(script=[(THETA * (1 + 0.1 * i), np.full(6, 0.5)) for i in range(20)],
                   callback=lambda it, settled: it >= 2),
    "noconv": dict(script=[(THETA * (1 + 0.1 * i), np.full(6, 0.5)) for i in range(200)],
                   max_iters=5),
}


def reference_exit(monkeypatch, script, tol=1e-6, max_iters=40, callback=None):
    """The reference driver on `script`: (its exit, its iteration). A "done" reads as the
    status of its last settling check ("settled" or "certified")."""
    seen = []
    check = ref_eigs._check

    def spy(*args, **kw):
        out = check(*args, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(ref_eigs, "_check", spy)
    (res, status, iters, _ops), _stages = _run_driver(monkeypatch, script, nev=NEV, tol=tol,
                                                      max_iters=max_iters, callback=callback)
    assert (res is None) == (status in ("nan", "cancel", "noconv"))
    return (seen[-1] if status == "done" else status), iters


def port_exit(script, tol=1e-6, max_iters=40, callback=None, tol_accept=1e-4):
    """The port's exit object on `script`, one row an iteration, in ortho_lobpcg's order:
    NaN, then cancellation, then the exit. Returns (exit, iteration, gate, rules)."""
    rules = eigs._ExitRules(NEV, tol, -1.0, max_iters, tol_accept)
    for it in range(1, max_iters + 1):
        theta, rel = script[min(it - 1, len(script) - 1)]
        exit_rule = rules.check(it, np.asarray(theta, np.float64), np.asarray(rel, np.float64))
        if exit_rule == "nan":
            return "nan", it, rules.gate, rules
        if callback is not None and callback(it, rules.settled):
            return "cancel", it, rules.gate, rules
        if exit_rule:
            return exit_rule, it, rules.gate, rules
    return "noconv", max_iters, rules.gate, rules


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_reference_driver_scripts_give_the_reference_exit(monkeypatch, name):
    """Each TestDriverExits script gives the same exit through both, the iteration at most
    one apart; the reference's handoff is the port's gate, and after it the port runs on
    (here to its budget, with no pair accepted: "noconv")."""
    case = SCRIPTS[name]
    kw = {k: v for k, v in case.items() if k != "script"}
    ref, ref_it = reference_exit(monkeypatch, case["script"], **kw)
    got, it, gate, _rules = port_exit(case["script"], **kw)
    assert ref == name
    if name == "handoff":
        assert got == "noconv" and gate is not None and abs(gate - ref_it) <= 1, (gate, ref_it)
    else:
        assert got == name and abs(it - ref_it) <= 1, (got, it, ref_it)
        assert gate is None


@pytest.mark.parametrize("script, stage_exit, gate, answer", [
    ([(_converging(i), np.full(6, 0.5)) for i in range(40)], "settled", 10, ("settled", 13)),
    ([(THETA * (1 + 0.01 * i), np.full(6, 1e-5)) for i in range(60)], "certified", 1,
     ("noconv", 40)),
    ([(_stuck_at_two(i), np.full(6, 0.3)) for i in range(60)], "handoff", 16, ("noconv", 40)),
], ids=["settled32", "certificate", "handoff"])
def test_the_gate_opens_where_the_reference_stage_hands_over(monkeypatch, script, stage_exit,
                                                            gate, answer):
    """Below 3e-7 the reference runs its f32 stage at tol32 = 3e-7 and hands whatever it
    answers, or its handoff, to the f64 polish. The port's gate opens at that iteration (at
    most one apart), and the certificate does not answer there: only the settled rule at
    `tol` (1e-8) or the budget does."""
    ref, ref_it = reference_exit(monkeypatch, script, tol=eigs.TOL32)
    got, it, got_gate, _rules = port_exit(script, tol=1e-8)
    assert ref == stage_exit and got_gate == gate and abs(gate - ref_it) <= 1, (ref_it, got_gate)
    assert (got, it) == answer


@pytest.mark.parametrize("max_iters", [20, 40])
def test_stagnation_exit_is_left_out(max_iters):
    """A script that meets the reference polish's stagnation rule after the gate: the prefix
    stuck at 2 of 4 with the values moving 1e-6 (under tol_accept, over tol32), so the
    handoff opens the gate at 16 and the polish would answer "stagnated" 9 iterations later.
    The port has no such exit: the budget rule answers at the last iteration, and never
    before the gate either."""
    script = [(_stuck_at_two(i, wobble=1e-6), np.full(6, 0.3)) for i in range(60)]
    got, it, gate, rules = port_exit(script, tol=1e-8, max_iters=max_iters)
    assert (got, it, gate) == ("budget", max_iters, 16)
    assert rules.settled == 2 and rules.settled_acc == NEV
    assert set(lobpcg.DEVICE_EXITS) == {"certified", "settled", "budget"}


@pytest.mark.parametrize("tol, answer", [(1e-6, "certified"), (eigs.TOL32, "certified"),
                                         (1e-8, "settled")])
def test_order_nan_then_certified_then_settled(tol, answer):
    """The reference's _check order: a NaN row answers "nan" whatever its residuals; a row
    both certified and settled answers "certified" at tol >= 3e-7; below, the certificate
    only opens the gate and the settled rule answers."""
    nan_row = [(np.full(6, np.nan), np.full(6, 1e-6))]
    assert port_exit(nan_row, tol=tol)[:2] == ("nan", 1)
    script = [(THETA, np.full(6, 0.5))] + [(THETA, np.full(6, 1e-6))] * 5
    got, it, gate, _rules = port_exit(script, tol=tol)
    assert (got, it) == ((answer, 2) if answer == "certified" else (answer, 3))
    assert gate == (2 if answer == "settled" else None)


def test_certificate_reads_the_whole_window():
    """One pair over res_exit (1e-3 at these tolerances) keeps the certificate closed, and a
    non-finite residual does too."""
    rules = eigs._ExitRules(NEV, 1e-6, -1.0, 40)
    assert rules.res_exit == 1e-3
    drift = [THETA * (1 + 0.01 * i) for i in range(3)]
    assert rules.check(1, drift[0], np.array([1e-5, 1e-5, 2e-3, 1e-5, 0.5, 0.5])) is None
    assert rules.check(2, drift[1], np.array([1e-5, np.nan, 1e-5, 1e-5, 1e-5, 1e-5])) is None
    # Pairs past nev (the guard columns) are not read.
    assert rules.check(3, drift[2], np.array([1e-5] * 4 + [0.5, 0.5])) == "certified"


@pytest.fixture(scope="module")
def bar():
    mesh = bar_tets(0.2, 0.06, 0.05, 7, 3, 3)
    return mesh, mesh.points[:: max(mesh.points.shape[0] // 6, 1)][:6]


def test_locked_solve_matches_unlocked(bar, monkeypatch):
    """TestSoftLocking on the port: with _LOCK_STEP = 4 the lock engages (W/P shrink to the
    unsettled suffix: fewer columns into the inner solve), and the eigenvalues match the
    unlocked solve at rtol 1e-6."""
    mesh, excite = bar
    cfg = SolverConfig(num_modes=16, num_fem_modes=24, small_n=0, tolerance=1e-8,
                       max_mode_freq=96_000.0)
    inner = eigs._pcg_block

    def solve():
        columns = []

        def spy(apply_a, precond, b, iters):
            columns.append(b.shape[1])
            return inner(apply_a, precond, b, iters)

        monkeypatch.setattr(eigs, "_pcg_block", spy)
        res = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, device="cpu")
        return res, [columns[0] - c for c in columns]

    monkeypatch.setattr(eigs, "_LOCK_STEP", 4)
    monkeypatch.setattr(eigs, "_LOCK_MARGIN", 2)
    locked, locks = solve()
    monkeypatch.setattr(eigs, "_LOCK_STEP", 10**9)
    plain, plain_locks = solve()
    assert max(locks) > 0, "locking never engaged"
    assert max(plain_locks) == 0
    np.testing.assert_allclose(locked.summary.eigenvalues, plain.summary.eigenvalues, rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(num_modes=0, inner_iters=10_000, tolerance=1.0, guard=-3),
    dict(tol_accept=1.0, max_restarts=0, warm_tolerance=0.0),
    dict(),
], ids=["out_of_bounds", "acceptance_and_budget", "defaults"])
def test_solver_config_clamp(kw):
    """TestSolverConfigClamp on the port's SolverConfig, and the same clamp as the
    reference's on each config."""
    got = SolverConfig(**kw).clamp()
    assert vars(got) == vars(RefSolverConfig(**kw).clamp())
    if kw.get("num_modes") == 0:
        assert (got.num_modes, got.inner_iters, got.tolerance, got.guard) == (1, 256, 1e-2, 0)
    if not kw:
        assert got == SolverConfig()


def test_certificate_answers_a_real_pencil_at_the_bench_tolerance():
    """The bar's pencil (2,205 dofs) through the engine at the bench's tolerance (1e-6): the
    certificate answers, counted under its exit, with the eigenvalues within 1e-6 of the
    host shift-invert path's (the engine's parity, tests/test_torch_solve.py); at 1e-8 the
    certificate opens the gate and the settled rule answers later."""
    mesh = bar_tets(0.2, 0.06, 0.05, 7, 3, 3)
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, CERAMIC.properties, quad, device="cpu")
    sigma = -((2 * np.pi * SolverConfig().min_mode_freq) ** 2)
    pre = build_amg(mesh.points, kept, quad, ops, *pencil_diagonals(ops), sigma)
    host = lobpcg.lobpcg_pencil(ops, 45, sigma=sigma, precond=pre)
    assert host.exit == "host"
    before = dict(lobpcg.DEVICE_EXITS)
    cert = lobpcg.lobpcg_pencil(ops, 45, sigma=sigma, precond=pre, tol=1e-6, small_n=0)
    assert cert.exit == "certified" and cert.gate is None
    assert lobpcg.DEVICE_EXITS["certified"] == before["certified"] + 1
    assert np.abs(cert.eigenvalues[6:] / host.eigenvalues[6:] - 1).max() < 1e-6
    tight = lobpcg.lobpcg_pencil(ops, 45, sigma=sigma, precond=pre, tol=1e-8, small_n=0)
    assert tight.exit == "settled" and tight.gate is not None
    assert tight.gate < tight.iterations and tight.iterations > cert.iterations
