"""The port's multi-device layer (mesheditor_tpu_torch/parallel) against the JAX package's
on conftest's 8 virtual CPU devices, and against the port's own unsharded paths.

Each world size (1, 2, 4) is one spawn of CPU ranks under gloo (FileStore in tmp_path),
shared by every case through a module-scoped fixture; the ranks run
tests/torch_parallel_ranks.py, which imports only the port, and hand their results back
through files. The counterparts of tests/test_parallel.py, with its tolerances; the
element-sharded production solve is held to both the unsharded port and the JAX package's
unsharded solve (the reference's own sharded-solve test is red, ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mesheditor_tpu  # noqa: F401  (enables x64)
from mesheditor_tpu import SolverConfig as JaxSolverConfig
from mesheditor_tpu import mesh2modes as jax_mesh2modes
from mesheditor_tpu.api import make_synth as jax_make_synth
from mesheditor_tpu.fem import assembly as jax_assembly
from mesheditor_tpu.fem import build_quad_mesh as jax_build_quad_mesh
from mesheditor_tpu.parallel import make_mesh as jax_make_mesh
from mesheditor_tpu.parallel import shard_elements as jax_shard_elements
from mesheditor_tpu.parallel import shard_synth as jax_shard_synth
from mesheditor_tpu.parallel import sharded_pencil_ops as jax_sharded_pencil_ops
from mesheditor_tpu.parallel import sharded_subspace_step as jax_sharded_subspace_step
from mesheditor_tpu.synth import ModalEvent as JaxModalEvent

import torch_parallel_ranks as ranks
from mesheditor_tpu_torch import SolverConfig, mesh2modes
from mesheditor_tpu_torch.api import make_synth
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.parallel.dryrun import dryrun_multichip
from mesheditor_tpu_torch.parallel.launch import spawn
from test_parallel import _assert_spectra_match

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results at each world size, one spawn each, made on first use."""
    done = {}

    def get(world):
        if world not in done:
            done[world] = spawn(ranks.run_rank, world, device="cpu", backend="gloo",
                                args=(world,), workdir=tmp_path_factory.mktemp(f"w{world}"))
        return done[world]

    return get


@pytest.fixture(scope="module")
def jax_pencil_ops():
    """The JAX package's sharded matvecs and subspace step on its 8-device mesh."""
    from mesheditor_tpu.fem import filter_degenerate
    from mesheditor_tpu.mesh import bar_tets

    bar = bar_tets(0.2, 0.05, 0.05, 4, 2, 2)
    kept = filter_degenerate(bar.points, bar.tets)
    ops = jax_assembly.assemble_element_matrices(
        bar.points, kept, CERAMIC.properties, jax_build_quad_mesh(kept, bar.points.shape[0]))
    mesh = jax_make_mesh(8)
    ed, kb, rv = jax_shard_elements(np.asarray(ops.elem_dofs), np.asarray(ops.k_blocks),
                                    np.asarray(ops.rho_vol), mesh)
    kmat, mmat = jax_sharded_pencil_ops(mesh, ed, kb, rv, ops.m_unit, ops.n_dofs)
    return mesh, kmat, mmat, ops.n_dofs


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matvecs_match_reference_and_unsharded(runs, jax_pencil_ops, world):
    _mesh, kmat, mmat, n_dofs = jax_pencil_ops
    ops = ranks.pencil()
    x = ranks.panel(ops.n_dofs, 6, 0)
    assert ops.n_dofs == n_dofs
    results = runs(world)
    for r in results:  # the all_reduce hands every rank the same sum
        assert np.array_equal(r["kx"], results[0]["kx"])
        assert np.array_equal(r["mx"], results[0]["mx"])
    got = results[0]
    np.testing.assert_allclose(got["kx"], np.asarray(kmat(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-6)
    np.testing.assert_allclose(got["mx"], np.asarray(mmat(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-20)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(got["kx"], ops.kmat(xt).numpy(), rtol=1e-12, atol=1e-6)
    np.testing.assert_allclose(got["mx"], ops.mmat(xt).numpy(), rtol=1e-12, atol=1e-20)


@pytest.mark.parametrize("world", WORLDS)
def test_subspace_step_ritz_values_match_reference(runs, jax_pencil_ops, world):
    mesh, kmat, mmat, n_dofs = jax_pencil_ops
    step = jax_sharded_subspace_step(mesh, kmat, mmat)
    x1, theta1 = step(jnp.asarray(ranks.panel(n_dofs, 8, 2)), ranks.SIGMA)
    _x2, theta2 = step(x1, ranks.SIGMA)
    got1, got2 = runs(world)[0]["theta"]
    np.testing.assert_allclose(got1, np.asarray(theta1), rtol=1e-10)
    np.testing.assert_allclose(got2, np.asarray(theta2), rtol=1e-10)
    assert got2[0] <= got1[0] + 1e-6 * abs(got1[0])  # refinement is monotone


def _reference_mix(z, c_re, c_im, gains, excite):
    """tests/test_parallel.py:TestShardedRender._reference_mix."""
    z_re, z_im = z.copy(), z.copy()
    out = []
    for e in excite:
        z_re, z_im = z_re * c_re - z_im * c_im + e, z_re * c_im + z_im * c_re
        out.append((gains[:, None] * z_im).sum())
    return np.asarray(out)


@pytest.mark.parametrize("world", WORLDS)
def test_batched_render_step_matches_reference_at_every_width(runs, world):
    got = runs(world)
    for r in got:
        assert np.array_equal(r["step16"], got[0]["step16"])
    np.testing.assert_allclose(got[0]["step16"], _reference_mix(*ranks.render_bank(16)),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got[0]["step8"], runs(1)[0]["step8"], rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def unsharded_solves():
    """The port's unsharded solves of the bar (device engine, then the host path) and the
    JAX package's unsharded solve (its exact host path: its small_n=0 engine carries the
    pad-slot fault, ROADMAP Queue 3)."""
    bar, ex = ranks.solve_bar()
    engine = mesh2modes(bar, CERAMIC.properties, ex, config=ranks.SOLVE_CFG, device="cpu")
    host = mesh2modes(bar, CERAMIC.properties, ex, device="cpu", config=SolverConfig(
        num_modes=12, num_fem_modes=16, tolerance=1e-10, max_mode_freq=96_000.0))
    ref = jax_mesh2modes(bar, CERAMIC.properties, ex, config=JaxSolverConfig(
        num_modes=12, num_fem_modes=16, tolerance=1e-10, max_mode_freq=96_000.0))
    return engine, host, ref


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_production_solve_matches_unsharded_port_and_reference(
        runs, unsharded_solves, world):
    engine, _host, ref = unsharded_solves
    results = runs(world)
    for r in results:  # the group agrees on every eigenvalue
        assert np.array_equal(r["solve"][0], results[0]["solve"][0])
    lam, freqs, dofs = results[0]["solve"]
    assert dofs == engine.profile.dofs and freqs.size == engine.modes.num_modes > 0
    _assert_spectra_match(engine.summary.eigenvalues, lam)
    want = np.asarray(ref.summary.eigenvalues)
    assert lam.shape == want.shape and np.all(lam[:6] == 0.0)
    assert np.abs(lam[6:] / want[6:] - 1).max() < 1e-6
    assert np.abs(freqs / np.asarray(ref.modes.freqs) - 1).max() < 1e-6


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_below_small_n_is_the_host_path(runs, unsharded_solves, world):
    """Below small_n the group gathers the whole pencil and every rank takes the first
    rank's host answer. ARPACK's answers move ~1e-8 between calls (its start vector), so the
    bound is tests/test_torch_solve.py's 5e-8 for the host path."""
    _engine, host, _ref = unsharded_solves
    results = runs(world)
    for r in results:
        assert np.array_equal(r["host"][0], results[0]["host"][0])
    lam, freqs = results[0]["host"]
    want = host.summary.eigenvalues
    assert lam.shape == want.shape
    assert np.abs(lam[6:] / want[6:] - 1).max() < 5e-8
    assert np.abs(lam[:6]).max() < 1e-6 * want[6]
    np.testing.assert_allclose(freqs, host.modes.freqs, rtol=5e-8)


def _jax_sharded_render():
    """The JAX package's shard_synth on its 8 devices (tests/test_parallel.py's
    TestProductionRenderSharded scene)."""
    m = ranks.synth_modes()
    synth = jax_make_synth([m] * 8, sample_rate=48_000.0)
    synth.use_pallas = False
    for o in range(8):
        synth.enqueue(JaxModalEvent(kind="impact", obj=o, expos=o % 4, j=(0.05, 0.02, 0.01),
                                    pulse_step=1 / 96.0, pulse_gamma=np.pi / 2 / 96.0,
                                    accel_amp=0.001))
    return np.asarray(jax_shard_synth(synth, jax_make_mesh(8)).render(512), np.float64)


@pytest.fixture(scope="module")
def unsharded_renders():
    synth = make_synth([ranks.synth_modes()] * 8, sample_rate=48_000.0, device="cpu")
    ranks.strike_all(synth)
    impact_mix = synth.render(512).numpy().astype(np.float64)
    voiced = make_synth([ranks.synth_modes()] * 8, sample_rate=48_000.0, device="cpu")
    voiced_mix, carries = ranks.voiced_render(voiced)
    silent_click = make_synth([ranks.synth_modes()] * 8, sample_rate=48_000.0, device="cpu")
    silent_click.click_gain = 0.0
    no_click_mix, _ = ranks.voiced_render(silent_click)
    return impact_mix, _jax_sharded_render(), voiced_mix, carries, no_click_mix


@pytest.mark.parametrize("world", WORLDS)
def test_shard_synth_matches_unsharded_and_reference(runs, unsharded_renders, world):
    impact_mix, jax_mix, *_ = unsharded_renders
    results = runs(world)
    assert [r["objects"] for r in results] == [(8 * i // world, 8 * (i + 1) // world)
                                               for i in range(world)]
    got = results[0]["impact_mix"].astype(np.float64)
    for r in results:
        assert np.array_equal(r["impact_mix"], results[0]["impact_mix"])
    peak = max(np.abs(impact_mix).max(), 1e-30)
    assert np.abs(got - impact_mix).max() / peak < 1e-5
    assert np.abs(got - jax_mix).max() / np.abs(jax_mix).max() < 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_voiced_shard_synth_keeps_one_voice_table_and_one_click(runs, unsharded_renders,
                                                                world):
    _i, _j, voiced_mix, carries, no_click_mix = unsharded_renders
    results = runs(world)
    peak = np.abs(voiced_mix).max()
    click = voiced_mix - no_click_mix
    # The click is far above the tolerance: a click counted once per rank would fail it.
    assert np.abs(click).max() > 10 * 5e-5 * peak
    for r in results:
        got = r["voiced_mix"].astype(np.float64)
        assert np.abs(got - voiced_mix).max() / peak < 5e-5
        for field in ranks.CARRIES:  # the replicated voice table is the same on every rank
            assert np.array_equal(r["carries"][field], results[0]["carries"][field]), field
    for field in ("age", "primed", "active", "obj"):
        assert np.array_equal(results[0]["carries"][field], carries[field]), field
    for field in ("prev_height", "relief_mean", "penetration"):
        np.testing.assert_allclose(results[0]["carries"][field], carries[field], rtol=1e-4,
                                   atol=1e-12)


@pytest.mark.parametrize("world", (2, 4))
def test_dryrun_multichip_prints_its_line(capsys, tmp_path, world):
    results = dryrun_multichip(world, device="cpu", backend="gloo")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    tp = 2 if world == 4 else 1
    assert line.startswith(f"dryrun_multichip ok: mesh {{'dp': {world // tp}, 'tp': {tp}}}, "
                           "mesh2modes sharded solve f1=")
    assert "(8 modes, 1911 dofs), render_block voices+tracks rms=" in line
    assert len(results) == world and all(np.isfinite(r["out"]).all() for r in results)


def test_spawn_refuses_what_it_cannot_run_and_fails_with_a_rank(tmp_path):
    """No backend or device is chosen behind the caller's back, and a rank that raises
    fails the whole run while the others wait in a collective."""
    with pytest.raises(ValueError, match="NCCL"):
        spawn(ranks.fail_on_rank, 2, device="cpu", backend="nccl", args=(0,))
    with pytest.raises(ValueError, match="backend"):
        spawn(ranks.fail_on_rank, 2, device="cpu", backend="mpi", args=(0,))
    # Either the failing rank's own error or its peer's, whose collective it broke.
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        spawn(ranks.fail_on_rank, 2, device="cpu", backend="gloo", args=(1,),
              workdir=tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            spawn(ranks.fail_on_rank, 2, device="cuda", backend="gloo", args=(0,))
