"""The port's bench tools (mesheditor_tpu_torch/scripts/) against the reference's scripts/
on the CPU: render_bench's modes and scenes, the edit loop, the CDT solve and the RealImpact
corpus batch with its object-sharded verification render."""

import ast
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch.scripts import cdt_bench, edit_loop_bench, realimpact_batch
from mesheditor_tpu_torch.scripts import render_bench

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(radius=0.05, thickness=0.004, n_lat=5, n_lon=12, noise=0.05)  # test_realimpact_batch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def reference_script(name):
    """scripts/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---- render_bench ----


def test_cases_and_modes_match_the_reference():
    ref = reference_script("render_bench")
    tree = ast.parse((ROOT / "scripts" / "render_bench.py").read_text())
    cases = next(ast.literal_eval(node.value) for node in ast.walk(tree)
                 if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                 and node.targets[0].id == "cases")
    assert list(render_bench.CASES) == cases and len(cases) == 21
    for k in (64, 200, 512):
        a, b = render_bench.make_modes(k), ref.make_modes(k)
        for field in ("freqs", "t60s", "shapes", "positions"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def reference_scene(ref, n_objects, n_modes, n_voices, n_impacts):
    """scripts/render_bench.py:case's set-up on the JAX package: (synth, voices)."""
    from mesheditor_tpu.synth import ContactTrackSpec, ModalEvent, ModalSynth, SustainedVoice
    from mesheditor_tpu.synth.tracks import synthesize_roughness

    synth = ModalSynth([ref.make_modes(n_modes)] * n_objects, gains=[1.0] * n_objects,
                       max_impacts=max(n_impacts, 8), max_voices=max(n_voices, 1))
    slot = synth.adopt_track(1, lambda: synthesize_roughness(1e-4, -2.0, 1e-6))
    for i in range(n_impacts):
        synth.enqueue(ModalEvent("impact", obj=i % n_objects, expos=0, j=(0.05, 0.02, 0),
                                 pulse_step=1 / 2000.0, pulse_gamma=np.pi / 2 / 2000.0))
    voices = [
        SustainedVoice(
            voice_id=v + 1, obj=v % n_objects, blend_points=(0, 1, 2),
            blend_weights=(0.5, 0.3, 0.2), normal=(0, 1, 0), slip_dir=(1, 0, 0),
            sweep_dir=((1, 0, 0), (0, 0, -1)), normal_force=4.0, friction=0.4,
            stiffness=2.0**28, static_penetration=2.0**-20, damping_coeff=0.3,
            tracks=tuple(ContactTrackSpec(slot, 0.4, 2e-7, 8.0, 4e-7) for _ in range(4)),
        )
        for v in range(n_voices)
    ]
    return synth, voices


# (case, output tolerance x the block's peak): test_torch_impact.py's impact tolerance and
# test_torch_sustained.py's coupled one.
@pytest.mark.parametrize("shape, tol", [((2, 64, 0, 4), 2e-5), ((2, 64, 3, 1), 5e-5)],
                         ids=["impact", "voices"])
def test_scene_renders_like_the_reference(shape, tol):
    """The first 4 blocks of a case's scene, published and rendered block by block as
    `case` streams it, in both packages."""
    ref = reference_script("render_bench")
    port_synth, port_voices = render_bench.scene(*shape, device="cpu")
    ref_synth, ref_voices = reference_scene(ref, *shape)
    for block in range(4):
        if port_voices:
            port_synth.publish_voices(port_voices)
            ref_synth.publish_voices(ref_voices)
        got = port_synth.render(render_bench.BLOCK).numpy()
        want = np.asarray(ref_synth.render(render_bench.BLOCK))
        peak = np.abs(want).max()
        assert peak > 0 and np.isfinite(got).all()
        assert np.abs(got - want).max() < tol * peak, f"block {block}"


def test_case_counts_and_checks_a_timed_stretch():
    """`case` streams blocks (voice cases always) or renders one fused call; on the CPU no
    kernel launches."""
    streamed = render_bench.case(1, 64, 1, 1, blocks=2, fused=True, device="cpu")
    fused = render_bench.case(1, 64, 0, 1, blocks=2, fused=True, device="cpu")
    for r in (streamed, fused):
        assert r["finite"] and r["us_per_block"] > 0
        assert r["realtime_x"] == pytest.approx(render_bench.DEADLINE_US / r["us_per_block"])
        assert (r["impact_launches"], r["coupled_launches"]) == (0, 0)


# ---- edit_loop_bench ----


def test_edit_loop_matches_the_reference():
    """Cold, warm (Poisson edit seeded with the cold basis) and rescaled (E x 0.8, rho x
    1.3) f1 against the JAX package's same three steps on the same small box; the rescale
    against its closed form."""
    from mesheditor_tpu import SolverConfig, mesh2modes
    from mesheditor_tpu.materials import CERAMIC
    from mesheditor_tpu.mesh import box_tets
    from mesheditor_tpu.solve.mesh2modes import SolveReuse
    from mesheditor_tpu.solve.postprocess import rescale_modes
    from mesheditor_tpu.types import AcousticMaterialProperties

    resolution, n_modes = (4, 3, 2), 24
    got = edit_loop_bench.edit_loop(resolution, n_modes, device="cpu", progress=None)
    mesh = box_tets((0.3, 0.16, 0.15), resolution)
    cfg = SolverConfig(num_modes=n_modes, num_fem_modes=n_modes, max_mode_freq=48_000.0,
                       tolerance=1e-6)
    excite = mesh.points[:: max(mesh.points.shape[0] // 10, 1)][:10]
    mat = CERAMIC.properties
    cold = mesh2modes(mesh, mat, excite, config=cfg, reuse=SolveReuse(keep_basis=True))
    mat_nu = AcousticMaterialProperties(mat.density, mat.young_modulus,
                                        mat.poisson_ratio + 0.02, mat.alpha, mat.beta)
    warm = mesh2modes(mesh, mat_nu, excite, config=cfg,
                      reuse=SolveReuse(seed_basis=cold.basis))
    mat_e = AcousticMaterialProperties(mat.density * 1.3, mat.young_modulus * 0.8,
                                       mat.poisson_ratio, mat.alpha, mat.beta)
    rescaled = rescale_modes(cold.summary, cold.modes, mat_e, cfg)
    for name, ref in (("cold", cold.modes), ("warm", warm.modes), ("rescaled", rescaled)):
        port = got[name] if name == "rescaled" else got[name].modes
        assert port.num_modes == ref.num_modes, name
        np.testing.assert_allclose(port.freqs[0], ref.freqs[0], rtol=1e-6, err_msg=name)
    # The closed form of the rescale: the cold solve's eigenvalues times 0.8 / 1.3, taken
    # through the Rayleigh-damped frequency in float64; f1 is the lowest at or above the
    # audible floor. The model's frequencies are float32 (6e-8 relative), so the rescaled
    # f1 is the float32 rounding of the closed form.
    lam = got["cold"].summary.eigenvalues
    omega = np.sqrt(lam[lam > (2 * np.pi * cfg.min_mode_freq) ** 2 * 1e-10] * 0.8 / 1.3)
    c = mat_e.alpha + mat_e.beta * omega**2
    damped = np.sqrt(np.maximum(omega**2 - 0.25 * c**2, 0.0)) / (2 * np.pi)
    closed = damped[damped >= cfg.min_mode_freq][0]
    assert got["rescaled"].freqs[0] == np.float32(closed)


# ---- cdt_bench ----


def test_cdt_case_matches_the_reference():
    """The jittered icosphere at a small subdivision and lattice: the same Delaunay mesh as
    the JAX package's (one mesher source), the same dofs and modes, f1 within 1e-6, and
    scripts/cdt_bench.py's keys plus the card and the answering path."""
    from mesheditor_tpu import SolverConfig, mesh2modes
    from mesheditor_tpu.materials import CERAMIC
    from mesheditor_tpu.mesh import icosphere_surface
    from mesheditor_tpu.mesh.cdt import generate_tets_delaunay

    modes, subdiv, lattice = 32, 1, 4
    got = cdt_bench.cdt_case(modes=modes, subdiv=subdiv, lattice=lattice, device="cpu")
    pts, tris = icosphere_surface(subdiv)
    pts = pts * 0.05
    pts = pts + np.random.default_rng(7).standard_normal(pts.shape) * (0.02 * 0.05)
    mesh = generate_tets_delaunay(pts, tris, lattice_h=float((pts.max(0) - pts.min(0)).max())
                                  / lattice)
    excite = mesh.points[:: max(mesh.points.shape[0] // 10, 1)][:10]
    ref = mesh2modes(mesh, CERAMIC.properties, excite,
                     config=SolverConfig(num_modes=modes, num_fem_modes=modes,
                                         max_mode_freq=48_000.0, tolerance=1e-6))
    assert got["tets"] == mesh.tets.shape[0]
    assert got["dofs"] == ref.profile.dofs and got["modes"] == ref.modes.num_modes
    np.testing.assert_allclose(got["f1_hz"], float(ref.modes.freqs[0]), rtol=1e-6)
    assert got["path"] == "host" and got["card"] == "cpu"  # below small_n: the host answers
    tree = ast.parse((ROOT / "scripts" / "cdt_bench.py").read_text())
    keys = next([k.value for k in node.keys] for node in ast.walk(tree)
                if isinstance(node, ast.Dict) and node.keys
                and getattr(node.keys[0], "value", None) == "metric")
    assert list(got) == keys + ["path", "card"]


# ---- realimpact_batch ----


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    """tests/test_realimpact_batch.py's two doubles."""
    import sys

    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from make_realimpact_double import make_double
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    root = tmp_path_factory.mktemp("ri_corpus")
    make_double(root, name="1_CeramicKoiBowl", frames=4800, tet_resolution=6,
                n_modes=10, bowl_kw=TINY, seed=3)
    make_double(root, name="2_GlassGoblet", frames=4800, tet_resolution=6,
                n_modes=10, bowl_kw=dict(TINY, radius=0.04), seed=5)
    return root


@pytest.fixture(scope="module")
def port_batch(corpus_root):
    """The port's batch_solve over the two doubles on the CPU: (rows, results)."""
    return realimpact_batch.batch_solve(str(corpus_root), tet_resolution=6, n_modes=12,
                                        progress=None, device="cpu")


def test_batch_solve_rows_match_the_reference(corpus_root, port_batch):
    ref = reference_script("realimpact_batch")
    rows, results = port_batch
    ref_rows, _ = ref.batch_solve(str(corpus_root), tet_resolution=6, n_modes=12,
                                  progress=None)
    assert len(rows) == len(ref_rows) == 2 and len(results) == 2
    for row, want in zip(rows, ref_rows):
        assert list(row) == list(want)
        for key in ("object", "material", "dofs", "k_nnz", "modes"):
            assert row[key] == want[key], key
        assert set(row["stage_s"]) == set(want["stage_s"])
        np.testing.assert_allclose(row["f1_hz"], want["f1_hz"], rtol=1e-6)
    assert {r["material"] for r in rows} == {"Ceramic", "Glass"}


def test_verification_render_at_two_ranks_matches_the_reference(port_batch):
    """The object-sharded verification mix over 2 gloo ranks against the reference's over a
    2-device mesh, both from the port's solved models."""
    ref = reference_script("realimpact_batch")
    _rows, results = port_batch
    from mesheditor_tpu.types import ModalModes

    ref_results = [SimpleNamespace(modes=ModalModes(r.modes.freqs, r.modes.t60s,
                                                    r.modes.shapes)) for r in results]
    mix = realimpact_batch.sharded_verification_render(results, n_devices=2, device="cpu")
    want = ref.sharded_verification_render(ref_results, n_devices=2)
    assert mix.shape == want.shape == (512,) and mix.dtype == np.float32
    peak = np.abs(want).max()
    assert peak > 0 and np.isfinite(mix).all()
    assert np.abs(mix - want).max() < 1e-6 * peak


def test_scripts_need_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    for call in (lambda: render_bench.main(["--blocks", "1"]),
                 lambda: edit_loop_bench.main([]), lambda: cdt_bench.main(["--subdiv", "0"]),
                 lambda: realimpact_batch.main([str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
