"""The general-pencil form of lobpcg_pencil (operator callables) on the port, held to the
reference's: its closure engine (mesheditor_tpu/solve/lobpcg.py:_lobpcg_legacy) against
the port's on the same pencil from the same start panel, its routing of the callable form
(lobpcg.py:486-503), and the reference's scripts/check_eigensolver.py against the port's.

Each pencil is built once in numpy (the 8x2x2 bar of the reference's script: 1,275 dofs,
20 modes, 24 inner CG steps, tol 1e-8) and handed to both packages as dense matrices; both
engines start from one seeded panel `x0` of nev + guard columns (JAX's random stream
cannot be matched). Tolerances, each stated where it is held: the elastic eigenvalues
agree with the reference's within 1e-6 relative, the audible frequencies with scipy's
shift-invert within 1e-6, and the six rigid eigenvalues lie under 1e-6 of the first
elastic one in magnitude without being exact zeros; the port settles within 2 iterations
of the reference's engine. The reference sends its coefficients and B through float32,
which the port leaves out: that, not the port, is where the two answers part (the port
lands ~1e-11 from scipy, the reference ~4e-8).
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from mesheditor_tpu.solve import lobpcg as ref_lobpcg

from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                      filter_degenerate, pencil_diagonals)
from mesheditor_tpu_torch.mesh import bar_tets
from mesheditor_tpu_torch.scripts import check_eigensolver
from mesheditor_tpu_torch.solve import lobpcg
from mesheditor_tpu_torch.solve.amg import build_amg
from mesheditor_tpu_torch.types import AcousticMaterialProperties

ROOT = Path(__file__).resolve().parent.parent
NEV, GUARD, INNER, TOL, MAX_ITERS = 20, 15, 24, 1e-8, 200
SIGMA = -((2 * np.pi * 20.0) ** 2)
EIG_RTOL = 1e-6  # elastic eigenvalues, port against the reference's engine
FREQ_RTOL = 1e-6  # audible frequencies, port against scipy's shift-invert
RIGID_RTOL = 1e-6  # |rigid eigenvalue| against the first elastic eigenvalue
ITER_SLACK = 2  # the port's iterations against the reference engine's
TRACE = re.compile(r"\[eig\] it=(\d+) settled=(\d+)/(\d+) blocker: lam=(\S+) delta=(\S+) "
                   r"rel=(\S+) window=(\S+)$")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bar():
    """The reference script's bar: the port's element operators, the assembled pencil as
    dense float64 numpy, its diagonals, scipy's eigenvalues and the shared start panel."""
    mesh = bar_tets(0.3, 0.05, 0.05, 8, 2, 2)
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept,
                                    AcousticMaterialProperties(1000, 1e7, 0.0), quad,
                                    device="cpu")
    k, m = lobpcg._pencil_csr(ops)
    v0 = np.random.default_rng(0).uniform(-1.0, 1.0, ops.n_dofs)
    vals = np.sort(spla.eigsh(k, k=NEV, M=m, sigma=SIGMA, which="LM", v0=v0,
                              return_eigenvectors=False))
    x0 = np.random.default_rng(20261017).standard_normal((ops.n_dofs, NEV + GUARD))
    return dict(mesh=mesh, kept=kept, quad=quad, ops=ops, n=ops.n_dofs, k=k.toarray(),
                m=m.toarray(), kd=k.diagonal().copy(), md=m.diagonal().copy(), scipy=vals,
                x0=x0)


def pencil_args(bar, variant, lib):
    """(kmat, mmat, k_diag, m_diag, keywords) of `variant` as tensors of `lib` ("port":
    torch, "reference": jax.numpy): "jacobi" bare callables; "f32 pencil" the same with
    kmat_pc/mmat_pc on float32 copies; "dense state" callables of an op_state that is a
    tuple (K, M), not ElementOperators."""
    arr = (lambda a: torch.as_tensor(a)) if lib == "port" else jnp.asarray
    k, m = arr(bar["k"]), arr(bar["m"])
    kw = {}
    if variant == "dense state":
        kw["op_state"] = (k, m)
        kmat, mmat = (lambda o, x: o[0] @ x), (lambda o, x: o[1] @ x)
    else:
        kmat, mmat = (lambda x: k @ x), (lambda x: m @ x)
    if variant == "f32 pencil":
        k32, m32 = arr(bar["k"].astype(np.float32)), arr(bar["m"].astype(np.float32))
        kw.update(kmat_pc=lambda o, x: k32 @ x, mmat_pc=lambda o, x: m32 @ x)
    return kmat, mmat, arr(bar["kd"]), arr(bar["md"]), kw


def counts():
    return lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES, lobpcg.CLOSURE_SOLVES


def solve(bar, lib, variant="jacobi", **kw):
    """The callable form through `lib`'s lobpcg_pencil at the script's settings from the
    shared x0 (keywords override). Returns (result, (device, host, closure) solves it added
    on the port, stdout lines)."""
    kmat, mmat, kd, md, extra = pencil_args(bar, variant, lib)
    args = dict(sigma=SIGMA, x0=bar["x0"], guard=GUARD, tol=TOL, max_iters=MAX_ITERS,
                inner_iters=INNER) | extra | kw
    entry = lobpcg.lobpcg_pencil if lib == "port" else ref_lobpcg.lobpcg_pencil
    before = counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = entry(kmat, mmat, kd, md, bar["n"], NEV, **args)
    moved = tuple(a - b for a, b in zip(counts(), before))
    return res, moved, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def solved(bar):
    """Both engines on each variant, once, with the trace on (it changes no answer)."""
    cache = {}

    def get(lib, variant):
        if (lib, variant) not in cache:
            cache[lib, variant] = solve(bar, lib, variant, debug=True)
        return cache[lib, variant]

    return get


def op_rule(res, refresh_every=0):
    return check_eigensolver.op_rule(res.iterations, INNER,
                                     res.iterations // refresh_every if refresh_every else 0)


def held_to_oracles(res, ref, bar):
    """The acceptance bars of one port answer against the reference's and scipy's."""
    lam = res.eigenvalues
    assert lam.size == NEV and np.isfinite(lam).all()
    assert abs(res.iterations - ref.iterations) <= ITER_SLACK, (res.iterations, ref.iterations)
    assert np.abs(lam[6:] / ref.eigenvalues[6:] - 1).max() < EIG_RTOL
    f = np.sqrt(np.maximum(lam, 0)) / (2 * np.pi)
    f_ref = np.sqrt(np.maximum(bar["scipy"], 0)) / (2 * np.pi)
    audible = f_ref > 20
    assert audible.sum() == 14
    assert (np.abs(f - f_ref)[audible] / f_ref[audible]).max() < FREQ_RTOL
    assert np.abs(lam[:6]).max() < RIGID_RTOL * lam[6] and (lam[:6] != 0).any()
    u = res.eigenvectors
    assert u.shape == (bar["n"], NEV) and u.dtype == torch.float64
    gram = u.T @ torch.as_tensor(bar["m"]) @ u
    assert (gram - torch.eye(NEV, dtype=torch.float64)).abs().max() < 1e-10
    assert res.residual_norms.shape == (NEV,) and np.isfinite(res.residual_norms).all()


@pytest.mark.parametrize("variant", ["jacobi", "f32 pencil", "dense state"])
def test_closure_engine_matches_the_reference(bar, solved, variant):
    """Each preconditioner variant through both closure engines: the port answers by its
    own path (counted in CLOSURE_SOLVES, no device or host solve), its panels follow the
    op-count rule (3 + iterations x (2 + 2 x 24)) as the reference's do, and it meets the
    acceptance bars against the reference's answer and scipy's."""
    res, moved, _ = solved("port", variant)
    ref, _, _ = solved("reference", variant)
    assert moved == (0, 0, 1) and res.exit == "closure"
    assert res.op_applications == op_rule(res) and ref.op_applications == op_rule(ref)
    held_to_oracles(res, ref, bar)


@pytest.mark.parametrize("refresh_every", [3, 7])
def test_refresh_keeps_the_answer(bar, solved, refresh_every):
    """refresh_every=3: K X and M X recomputed at iterations 3 and 6 before the bar settles
    at 7, against the reference at the same setting; 7: the refresh falls on the iteration
    that answers, so the answer is the refreshed basis's leading columns (the reference's
    recombination after a refresh), equal to the unrefreshed run's (the iterations up to
    it are the same arithmetic). Each refresh adds 2 panels."""
    res, moved, _ = solve(bar, "port", refresh_every=refresh_every)
    assert moved == (0, 0, 1)
    assert res.op_applications == op_rule(res, refresh_every)
    plain, _, _ = solved("port", "jacobi")
    if refresh_every == 3:
        ref, _, _ = solve(bar, "reference", refresh_every=3)
        assert ref.op_applications == op_rule(ref, 3)
        assert res.iterations // 3 >= 2
        held_to_oracles(res, ref, bar)
    else:
        assert res.iterations == plain.iterations == refresh_every
        assert np.array_equal(res.eigenvalues, plain.eigenvalues)
        assert torch.allclose(res.eigenvectors, plain.eigenvectors, rtol=0, atol=1e-12)


def test_trace_has_the_reference_fields(bar, solved, monkeypatch):
    """debug=True prints one `[eig]` line an iteration, numbered from 1, with the
    reference's fields in its order and format, ending settled; with debug left at None,
    MESHEDITOR_TPU_DEBUG_EIG switches it on, and the answer is the same bit for bit."""
    res, _, lines = solved("port", "jacobi")
    ref, _, ref_lines = solved("reference", "jacobi")
    assert len(lines) == res.iterations and len(ref_lines) == ref.iterations
    fields = [TRACE.match(line) for line in lines]
    assert all(fields), lines
    assert [int(f[1]) for f in fields] == list(range(1, res.iterations + 1))
    assert all(f[3] == str(NEV) for f in fields) and fields[-1][2] == str(NEV)
    shape = re.compile(r"=\S+")
    assert all(TRACE.match(line) for line in ref_lines)
    assert {shape.sub("=", line) for line in lines} == {shape.sub("=", ref_lines[0])}
    monkeypatch.setenv("MESHEDITOR_TPU_DEBUG_EIG", "1")
    again, _, env_lines = solve(bar, "port")
    assert env_lines == lines and np.array_equal(again.eigenvalues, res.eigenvalues)
    assert torch.equal(again.eigenvectors, res.eigenvectors)
    monkeypatch.delenv("MESHEDITOR_TPU_DEBUG_EIG")
    _, _, quiet = solve(bar, "port")
    assert quiet == []


@pytest.mark.parametrize("how", ["budget", "cancel"])
def test_empty_result_without_a_host_solve(bar, how):
    """A budget spent before the bar settles (max_iters=1), and a callback that cancels at
    iteration 2, give the empty result in both packages, with the same iterations and
    panels; the port's closure engine never asks the host path (HOST_SOLVES unchanged)."""
    seen = []

    def cancel(iteration, settled):
        seen.append((iteration, settled))
        return iteration == 2

    kw = dict(max_iters=1) if how == "budget" else dict(callback=cancel)
    res, moved, _ = solve(bar, "port", **kw)
    ref, _, _ = solve(bar, "reference", **kw)
    assert moved == (0, 0, 0)
    assert res.eigenvalues.size == 0 and res.eigenvectors.shape == (bar["n"], 0)
    assert res.exit == "" and ref.eigenvalues.size == 0
    assert res.iterations == ref.iterations == (1 if how == "budget" else 2)
    assert res.op_applications == ref.op_applications == op_rule(res)
    if how == "cancel":
        # the port's calls, then the reference's
        assert [i for i, _ in seen] == [1, 2] * 2 and all(0 <= s <= NEV for _, s in seen)


@pytest.fixture(scope="module")
def amg(bar):
    ops = bar["ops"]
    kd, md = pencil_diagonals(ops)
    return kd, md, build_amg(bar["mesh"].points, bar["kept"], bar["quad"], ops, kd, md, SIGMA)


def test_routing_call_matches_the_element_form(bar, amg):
    """tests/test_amg.py's call (lambdas, op_state=ElementOperators, kmat_pc/mmat_pc,
    precond=AMG, small_n=1, host_fallback_n=0) routes to the element form: the device
    engine, its eigenvalues and vectors equal to lobpcg_pencil(ops, nev, ...)'s bit for
    bit; at n <= small_n the same call takes the host path, equal to the element form's."""
    ops = bar["ops"]
    kd, md, pre = amg
    kw = dict(sigma=SIGMA, tol=1e-8, max_iters=100, inner_iters=16, precond=pre)
    pc = dict(kmat_pc=lambda o, x: o.kmat(x.double()).float(),
              mmat_pc=lambda o, x: o.mmat(x.double()).float())
    for small in ({"small_n": 1, "host_fallback_n": 0}, {}):
        before = counts()
        routed = lobpcg.lobpcg_pencil(lambda o, x: o.kmat(x), lambda o, x: o.mmat(x), kd, md,
                                      bar["n"], 16, op_state=ops, **pc, **kw, **small)
        element = lobpcg.lobpcg_pencil(ops, 16, **kw, **small)
        moved = tuple(a - b for a, b in zip(counts(), before))
        assert moved == ((2, 0, 0) if small else (0, 2, 0)), moved
        assert routed.exit == element.exit == ("settled" if small else "host")
        assert routed.eigenvalues.size == 16
        assert np.array_equal(routed.eigenvalues, element.eigenvalues)
        assert torch.equal(routed.eigenvectors, element.eigenvectors)
        assert routed.iterations == element.iterations


def test_element_state_without_a_float32_pencil_takes_the_closure_engine(bar, amg):
    """An ElementOperators op_state above small_n with no kmat_pc is the reference's
    closure route too (the element engine needs its float32 pencil there): the port's
    answer comes from its closure engine, held to scipy."""
    ops = bar["ops"]
    kd, md, _ = amg
    before = counts()
    res = lobpcg.lobpcg_pencil(lambda o, x: o.kmat(x), lambda o, x: o.mmat(x), kd, md,
                               bar["n"], NEV, op_state=ops, sigma=SIGMA, x0=bar["x0"],
                               max_iters=MAX_ITERS, small_n=0)
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 1)
    assert res.exit == "closure" and res.op_applications == op_rule(res)
    f = np.sqrt(np.maximum(res.eigenvalues[6:], 0))
    assert np.abs(f / np.sqrt(bar["scipy"][6:]) - 1).max() < FREQ_RTOL


def test_malformed_calls_raise(bar):
    """Neither form, or the two mixed, is a TypeError."""
    ops = bar["ops"]
    with pytest.raises(TypeError):
        lobpcg.lobpcg_pencil(ops, 4, op_state=ops, sigma=SIGMA)
    with pytest.raises(TypeError):
        lobpcg.lobpcg_pencil(ops, 4, nev=4, sigma=SIGMA)
    with pytest.raises(TypeError):
        lobpcg.lobpcg_pencil(ops.kmat, ops.mmat, sigma=SIGMA)


def reference_script_lines(capsys, monkeypatch):
    """scripts/check_eigensolver.py at its defaults (no arguments), started from the port's
    fixed ARPACK vector (tests/test_torch_harness.py's seeded_arpack), as its printed
    lines."""
    from test_torch_harness import seeded_arpack

    monkeypatch.setattr(sys, "argv", ["check_eigensolver.py"])
    spec = importlib.util.spec_from_file_location("reference_check_eigensolver",
                                                  ROOT / "scripts" / "check_eigensolver.py")
    module = importlib.util.module_from_spec(spec)
    with seeded_arpack():
        spec.loader.exec_module(module)
    return capsys.readouterr().out.splitlines()


def test_script_default_against_the_reference_script(capsys, monkeypatch):
    """`python -m mesheditor_tpu_torch.scripts.check_eigensolver --device cpu` at its
    defaults runs the closure engine as the reference's script does: it prints each of the
    reference's lines, settles in 7 +- 2 iterations (the reference's script: 7, 353 panels),
    follows the op-count rule, lands under 1e-6 of scipy, and its rigid eigenvalues are the
    engine's own (not exact zeros, under 1e-6 of the first elastic one)."""
    ref_lines = reference_script_lines(capsys, monkeypatch)
    before = counts()
    out = check_eigensolver.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 1)
    ref_iters = int(re.search(r"iters=(\d+)", next(x for x in ref_lines
                                                   if x.startswith("lobpcg:")))[1])
    assert ref_iters == 7
    assert abs(out["iterations"] - ref_iters) <= ITER_SLACK
    assert out["op_applications"] == check_eigensolver.op_rule(out["iterations"], INNER)
    assert out["max_rel_err"] < FREQ_RTOL and out["engine"] == "closure, Jacobi"
    rigid = np.asarray(out["rigid"])
    first_elastic = (2 * np.pi * out["got_hz"][0]) ** 2
    assert (rigid != 0).any() and np.abs(rigid).max() < RIGID_RTOL * first_elastic
    for label in ("tets=", "scipy eigsh:", "lobpcg:", "freqs ref:", "freqs got:",
                  "max rel freq err (audible):", "rigid eigenvalues got:"):
        assert any(x.startswith(label) for x in ref_lines), label
        assert any(x.startswith(label) for x in lines), label
