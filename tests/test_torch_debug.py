"""The JAX package's debugging surface on the port: `synth.render_block(..., debug=True)`,
its per-sample traces and block precompute, and the device eigensolver's per-iteration
`[ortho]` trace (`lobpcg_pencil(debug=...)`, MESHEDITOR_TPU_DEBUG_EIG), each against the
JAX package on the same inputs made with numpy, and the diag_cdt_solve tool built on the
trace.

The port's debug route is its plain recurrence (synth/coupled.py:_resonate_coupled_plain
with `trace=True`), as the reference's is its scan. The reference's jitted `render_block`
does not mark `debug` static and raises on debug=True, so its `render_block_impl` is run
here op by op and as `jax.jit` with `debug` static.
"""

import contextlib
import io
import re
from functools import partial

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch import SolverConfig, mesh2modes
from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                      filter_degenerate, pencil_diagonals)
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import box_tets
from mesheditor_tpu_torch.scripts import diag_cdt_solve
from mesheditor_tpu_torch.solve.amg import build_amg
from mesheditor_tpu_torch.solve.lobpcg import lobpcg_pencil
from mesheditor_tpu_torch.synth import ModalSynth, render_block
from test_torch_impact import make_scene
from test_torch_sustained import VOICE_FIELDS, pool_rows, port_coupled, ref, voice_rows  # noqa: F401

DBG_KEYS = ("relief", "slope0", "slope1", "heights", "rm0", "rm_out", "pen_out", "rm_t",
            "pen_t", "force_t", "relief_t")
PRECOMPUTE = ("relief", "slope0", "slope1", "heights", "rm0")
N_BLOCKS, BLOCK = 3, 128
# The reference's eigs.py:_check line, and the port's.
ORTHO = re.compile(r"^\[ortho\] it=(\d+) settled=(\d+)/(\d+) lam_j=(\S+) set_rel=(\S+) "
                   r"res_max=(\S+) dt=(\S+)s$")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def debug_scene(voiced=True):
    """4 objects x 32 modes, 2 live impacts (objects 0 and 1), and a voice table of 4 rows:
    3 live voices, 2 of them on object 2, under loads of 4, 0.5 and 2 N (the tanh knee
    fires on some samples), and an inactive last row. Voice-free: no live row."""
    bank, imp = make_scene(n_obj=4, k=32, n_imp=4, impacts_per_obj=1, seed=23)
    imp["active"][2:] = False
    f32, i32 = voice_rows(1, 4)
    i32[:3, 0] = [2, 0, 2]
    f32[:3, 15] = [4.0, 0.5, 2.0]
    if not voiced:
        f32[:], i32[:] = 0.0, 0
    return bank, imp, (f32, i32), pool_rows()


def port_blocks(scene, n_blocks=N_BLOCKS, debug=True):
    """The port's render_block over consecutive blocks, each fed the last one's tables.
    Returns [(state, impacts, voices, out[, dbg]), ...]."""
    params, state, table, voices, pool = port_coupled(scene)
    blocks = []
    for _ in range(n_blocks):
        got = render_block(params, state, table, voices, pool, BLOCK, 1.0, 1.0, 1.0, debug)
        state, table, voices = got[:3]
        blocks.append(got)
    return blocks


# XLA's CPU compiler contracts the reference's jitted track read (`base + frac * h`, then a
# difference of two prefix sums several times the relief) into FMAs, so the jitted
# precompute and every trace fed by it sit up to 5.5e-5 of their scale (the slopes, which
# difference the heights again) from the same function run op by op, which the port
# matches bit for bit on these blocks.
JIT_TOL = 1e-4


@pytest.fixture(scope="module", params=["op by op", "jit"])
def jax_blocks(ref, request):
    """The reference's render_block_impl over the same blocks, op by op and jitted (with
    `debug` static). Returns (how, blocks)."""
    import jax

    step = partial(ref.impl, debug=True)
    if request.param == "jit":
        step = jax.jit(step, static_argnames=("num_samples",))
    params, state, table, voices, pool = ref.scene(debug_scene())
    blocks = []
    for _ in range(N_BLOCKS):
        got = step(params, state, table, voices, pool, num_samples=BLOCK)
        state, table, voices = got[:3]
        blocks.append(got)
    return request.param, blocks


def within(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} against {tol:g} x {scale:.3e}"


@pytest.mark.parametrize("block", range(N_BLOCKS))
def test_render_block_debug_matches_reference(jax_blocks, block):
    """Keys, shapes and dtypes of dbg as the reference's. Against the reference run op by
    op: the block precompute over every voice row, the carries and the traces over the
    live rows, within 1e-6 of their scale; force_t within 1e-5 x its peak; out within
    2e-6 x peak (two float32 orders of the recurrence, ROADMAP "Bounds"). Against the
    jitted reference the same with JIT_TOL for the precompute and the traces. Each package
    carries its own tables from block to block, so blocks 1 and 2 start from primed
    carries."""
    how, blocks = jax_blocks
    near, force_tol = (1e-6, 1e-5) if how == "op by op" else (JIT_TOL, JIT_TOL)
    *_tables, out, dbg = port_blocks(debug_scene())[block]
    *_ref_tables, want_out, want = blocks[block]
    assert tuple(dbg) == DBG_KEYS and sorted(want) == sorted(DBG_KEYS)  # jit sorts keys
    for key in DBG_KEYS:
        assert tuple(dbg[key].shape) == want[key].shape, key
        assert dbg[key].numpy().dtype == want[key].dtype, key
    live = np.array([True, True, True, False])
    for key in PRECOMPUTE:
        within(dbg[key].numpy(), want[key], near, key)
    for key in ("rm_out", "pen_out"):
        within(dbg[key].numpy()[live], np.asarray(want[key])[live], near, key)
    for key in ("rm_t", "pen_t", "relief_t"):
        within(dbg[key].numpy()[:, live], np.asarray(want[key])[:, live], near, key)
    within(dbg["force_t"].numpy()[:, live], np.asarray(want["force_t"])[:, live], force_tol,
           "force_t")
    within(out.numpy(), want_out, 2e-6, "out")
    assert np.asarray(want["force_t"])[:, live].max() > 0  # the contacts carry a load


def test_reference_jitted_render_block_refuses_debug(ref):
    """The reference's own jitted entry raises on debug=True (`debug` is traced, not
    static); the port's returns the five-tuple."""
    import jax
    from mesheditor_tpu.synth.render import render_block as jax_render_block

    with pytest.raises(jax.errors.TracerBoolConversionError):
        jax_render_block(*ref.scene(debug_scene()), BLOCK, debug=True)
    assert len(port_blocks(debug_scene(), 1)[0]) == 5


@pytest.mark.parametrize("voiced", [True, False])
def test_debug_route_against_default_route(voiced):
    """On the CPU both routes of a voiced block are the plain coupled recurrence: state,
    tables and mix are bit-identical. A voice-free block goes through the impact render
    without debug and through the coupled recurrence with it: the mix and the state agree
    within 2e-6 x peak, the impact table exactly, and `voices` is left as it was."""
    scene = debug_scene(voiced)
    for traced, plain in zip(port_blocks(scene), port_blocks(scene, debug=False)):
        (s_d, i_d, v_d, o_d, _dbg), (s_p, i_p, v_p, o_p) = traced, plain
        for f in ("active", "age"):
            assert torch.equal(getattr(i_d, f), getattr(i_p, f)), f
        for f in VOICE_FIELDS:
            assert torch.equal(getattr(v_d, f), getattr(v_p, f)), f
        if voiced:
            assert torch.equal(o_d, o_p)
            assert torch.equal(s_d.z_re, s_p.z_re) and torch.equal(s_d.z_im, s_p.z_im)
        else:
            peak = float(o_p.abs().max())
            assert peak > 0
            assert float((o_d - o_p).abs().max()) <= 2e-6 * peak
            assert torch.allclose(s_d.z_im, s_p.z_im, rtol=0, atol=2e-6 * peak)


@pytest.mark.parametrize("voiced", [True, False])
def test_trace_invariants(voiced):
    """rm_t's and pen_t's last rows are the carries out, bit for bit; relief_t is the
    relief precompute transposed; every entry is finite; rows of voices not stepped hold
    their carries in and no force."""
    for *_tables, out, dbg in port_blocks(debug_scene(voiced)):
        assert torch.equal(dbg["rm_t"][-1], dbg["rm_out"])
        assert torch.equal(dbg["pen_t"][-1], dbg["pen_out"])
        assert torch.equal(dbg["relief_t"], dbg["relief"].T)
        assert all(torch.isfinite(v).all() for v in dbg.values()) and torch.isfinite(out).all()
        idle = 3 if voiced else slice(None)
        assert (dbg["rm_t"][:, idle] == dbg["rm0"][idle]).all()
        assert (dbg["pen_t"][:, idle] == dbg["pen_out"][idle]).all()
        assert (dbg["force_t"][:, idle] == 0).all()


def test_debug_route_keeps_rest_silence():
    """chip_smoke.rest_silence's resting contact (k * delta0^(3/2) == N exactly): 8 blocks
    through the debug route render exactly 0.0, as through the default route."""
    from chip_smoke import rest_modes_and_track
    from mesheditor_tpu_torch.synth import ContactTrackSpec, SustainedVoice

    modes, track = rest_modes_and_track()
    synth = ModalSynth([modes], gains=[1.0], device="cpu")
    slot = synth.adopt_track(1, lambda: track)
    synth.publish_voices([SustainedVoice(
        voice_id=1, obj=0, blend_points=(0, 1, 0), blend_weights=(0.5, 0.5, 0.0),
        normal=(0.0, 1.0, 0.0), normal_force=2.0**4, friction=0.5, stiffness=2.0**31,
        static_penetration=2.0**-18, damping_coeff=0.4,
        tracks=tuple(ContactTrackSpec(index=slot, rate=0.0, sigma=2e-7, window=8.0, step=0.0)
                     for _ in range(4)))])
    synth._drain_events()
    synth._adopt_voices()
    state, impacts, voices = synth.state, synth.impacts, synth.voices
    for _ in range(8):
        state, impacts, voices, out, dbg = render_block(
            synth.params, state, impacts, voices, synth.pool, 512, synth.click_gain,
            synth.sustain_level, synth.coupling, debug=True)
        assert float(out.abs().max()) == 0.0
        assert float(dbg["force_t"][:, 0].min()) > 0  # the contact carries its load


def test_debug_refuses_a_sharded_bank():
    params, state, table, voices, pool = port_coupled(debug_scene())
    with pytest.raises(ValueError, match="shard"):
        render_block(params, state, table, voices, pool, BLOCK, debug=True, shard=object())


# ---- the eigensolver's per-iteration trace ----

BOX = ((0.3, 0.16, 0.15), (6, 4, 3))  # 2,457 dofs: the engine with small_n=0
NEV = 20


@pytest.fixture(scope="module")
def pencil():
    """The small box's element operators, AMG and shift, assembled once."""
    mesh = box_tets(*BOX)
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, CERAMIC.properties, quad, device="cpu")
    sigma = -((2 * np.pi * SolverConfig().min_mode_freq) ** 2)
    kd, md = pencil_diagonals(ops)
    return ops, build_amg(mesh.points, kept, quad, ops, kd, md, sigma), sigma


def solve(pencil, **kw):
    """lobpcg_pencil on the small box through the engine. Returns (result, stdout lines)."""
    ops, pre, sigma = pencil
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = lobpcg_pencil(ops, NEV, sigma=sigma, precond=pre, tol=1e-8, small_n=0, **kw)
    return res, buf.getvalue().splitlines()


@pytest.mark.parametrize("how", ["argument", "env var"])
def test_trace_is_one_line_an_iteration_and_changes_no_bit(pencil, how, monkeypatch):
    """debug=True, or MESHEDITOR_TPU_DEBUG_EIG with debug left at None, prints one
    `[ortho]` line an iteration, in order, settled counts of the 14 elastic pairs, then one
    `[ortho exit]` line naming the exit that answered; the eigenvalues and eigenvectors are
    those of the solve with the trace off, bit for bit."""
    monkeypatch.delenv("MESHEDITOR_TPU_DEBUG_EIG", raising=False)
    off, quiet = solve(pencil)
    assert quiet == [] and off.eigenvalues.size == NEV
    if how == "argument":
        on, lines = solve(pencil, debug=True)
    else:
        monkeypatch.setenv("MESHEDITOR_TPU_DEBUG_EIG", "1")
        on, lines = solve(pencil)
    *lines, exit_line = lines
    assert exit_line.startswith(f"[ortho exit] it={on.iterations} exit=settled "
                                f"settled={NEV - 6}/{NEV - 6} accepted={NEV - 6}/{NEV - 6} "), \
        exit_line
    fields = [ORTHO.match(line) for line in lines]
    assert all(fields) and len(lines) == on.iterations == off.iterations > 1
    assert [int(m[1]) for m in fields] == list(range(1, on.iterations + 1))
    assert {int(m[3]) for m in fields} == {NEV - 6}
    assert int(fields[-1][2]) == NEV - 6 and float(fields[0][5]) == float("inf")
    assert all(0 < float(m[6]) < 2 for m in fields)
    assert np.array_equal(on.eigenvalues, off.eigenvalues)
    assert torch.equal(on.eigenvectors, off.eigenvectors)
    assert np.array_equal(on.residual_norms, off.residual_norms)


def test_trace_env_var_off_and_argument_over_env(pencil, monkeypatch):
    """debug=False wins over the env var; with neither the engine prints nothing."""
    monkeypatch.setenv("MESHEDITOR_TPU_DEBUG_EIG", "1")
    assert solve(pencil, debug=False)[1] == []
    monkeypatch.delenv("MESHEDITOR_TPU_DEBUG_EIG")
    assert solve(pencil)[1] == []


def ortho_lines(text):
    return [line for line in text.splitlines() if line.startswith("[ortho]")]


def traces_on_one_mesh(mesh, cfg, monkeypatch, capsys):
    """The port's mesh2modes and the reference's on `mesh` at `cfg` with the trace on.
    Returns (port result, its [ortho] lines, reference result, its [ortho] lines)."""
    import mesheditor_tpu  # noqa: F401  (enables x64)
    from mesheditor_tpu.materials import CERAMIC as REF_CERAMIC
    from mesheditor_tpu.solve.mesh2modes import mesh2modes as ref_mesh2modes
    from mesheditor_tpu.types import SolverConfig as RefSolverConfig

    monkeypatch.setenv("MESHEDITOR_TPU_DEBUG_EIG", "1")
    excite = mesh.points[:4]
    capsys.readouterr()
    port = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, device="cpu")
    port_lines = ortho_lines(capsys.readouterr().out)
    reference = ref_mesh2modes(mesh, REF_CERAMIC.properties, excite,
                               config=RefSolverConfig(**vars(cfg)))
    return port, port_lines, reference, ortho_lines(capsys.readouterr().out)


def test_trace_parses_as_the_reference_trace_on_one_mesh(monkeypatch, capsys):
    """The small box through both packages' engines (small_n=0): both traces' `[ortho]`
    lines parse with one pattern, with the same elastic count; the port's count equals
    its iterations. (The reference's f32 stage ran 15 iterations at 0 settled here, then
    its f64 polish answered; the port took 9.)"""
    cfg = SolverConfig(num_modes=20, num_fem_modes=NEV, small_n=0)
    port, lines, reference, ref_lines = traces_on_one_mesh(box_tets(*BOX), cfg, monkeypatch,
                                                           capsys)
    assert lines and ref_lines
    assert all(ORTHO.match(line) for line in lines + ref_lines), (lines + ref_lines)[:4]
    assert len(lines) == port.profile.restarts
    assert {ORTHO.match(line)[3] for line in lines + ref_lines} == {str(NEV - 6)}
    assert reference.modes.num_modes == port.modes.num_modes > 0


@pytest.mark.slow
def test_trace_on_the_recipe_torus_against_the_reference(monkeypatch, capsys):
    """The SKILL recipe's torus (13,425 dofs, above small_n): the same pattern parses both
    packages' traces; the port's engine answers in its line count (9 here), the reference's
    after its f32 stage and polish (38). ~45 s on one CPU thread."""
    from mesheditor_tpu_torch.mesh import cdt, torus_surface

    pts, tris = torus_surface(0.06, 0.025, 24, 12)
    mesh = cdt.generate_tets_delaunay(
        pts, tris, lattice_h=float((pts.max(0) - pts.min(0)).max()) / 14)
    cfg = SolverConfig(num_modes=20, num_fem_modes=30)
    port, lines, reference, ref_lines = traces_on_one_mesh(mesh, cfg, monkeypatch, capsys)
    assert port.profile.dofs == 13_425
    assert lines and ref_lines and all(ORTHO.match(line) for line in lines + ref_lines)
    assert len(lines) == port.profile.restarts
    assert reference.modes.num_modes == port.modes.num_modes > 0


# ---- diag_cdt_solve ----


def test_diag_cdt_solve_small_lattice(capsys, monkeypatch):
    """The tool at bbox/6 on the CPU: each run prints its trace, its run line and both
    reports; the trace's line count is the run's iterations; the trace env var and the
    profile switch are put back."""
    from mesheditor_tpu_torch import profile

    monkeypatch.delenv("MESHEDITOR_TPU_DEBUG_EIG", raising=False)
    rows = diag_cdt_solve.main(["2", "--device", "cpu"], lattice=6)
    text = capsys.readouterr().out
    assert len(rows) == 2 and text.count("--- run ") == 2
    runs = text.split("--- run ")
    for row, before in zip(rows, runs[:-1]):
        assert row["modes"] > 0 and row["f1_hz"] > 0 and row["dofs"] > 0
        assert len(ortho_lines(before)) == row["iterations"] > 0
    assert rows[0]["f1_hz"] == rows[1]["f1_hz"]
    assert "mesh2modes" in text and "iterate" in text
    assert not profile.enabled
    import os

    assert "MESHEDITOR_TPU_DEBUG_EIG" not in os.environ


def test_diag_cdt_solve_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        diag_cdt_solve.main(["1"])
