"""The solve-input pipeline of the port against the JAX package: the input hash, the model
store, solve_surface (mesher -> FEM solve), batch solving and the orchestration helpers.

The same numpy inputs go through both packages. The surface solve is taken at a size whose
pencil (8,127 dofs) both packages answer on the host (sparse shift-invert), where repeated
ARPACK solves move by up to ~1e-8 relative: frequencies are held at 5e-8 in float64 (the
square roots of the solved eigenvalues), and the stored float32 frequencies and T60s at
5e-8 plus one float32 spacing."""

from dataclasses import replace

import numpy as np
import pytest
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
from mesheditor_tpu import api as ref_api
from mesheditor_tpu import materials as ref_materials
from mesheditor_tpu import types as ref_types
from mesheditor_tpu.io import model_store as ref_store
from mesheditor_tpu.solve import orchestration as ref_orch

from mesheditor_tpu_torch import SolverConfig, api, convert, mesh2modes
from mesheditor_tpu_torch.io import model_store
from mesheditor_tpu_torch.materials import CERAMIC, GLASS
from mesheditor_tpu_torch.mesh import bar_tets, cdt, icosphere_surface, torus_surface, voxel_tets
from mesheditor_tpu_torch.solve import batch, lobpcg, orchestration
from mesheditor_tpu_torch.types import MassProperties, ModalModes, ModalSolveSettings

HOST_PATH_RTOL = 5e-8
# ModalModes stores float32: two float64 answers inside HOST_PATH_RTOL may round to
# neighbouring float32 values, one spacing (at most 2**-23 relative) apart.
STORED_RTOL = HOST_PATH_RTOL + 2.0 ** -23


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _seeded_model(seed=7, k=9, p=4):
    rng = np.random.default_rng(seed)
    freqs = np.sort(rng.uniform(200, 9000, k))
    shapes = rng.standard_normal((p, k, 3)).astype(np.float32) * 0.02
    fields = dict(
        freqs=freqs, t60s=rng.uniform(0.05, 1.5, k), shapes=shapes,
        vertices=np.arange(p, dtype=np.uint32), positions=rng.random((p, 3), np.float32),
        indices=np.arange(p, dtype=np.uint32)[::-1].copy(),
        baked_scale=np.array([1.0, 2.0, 0.5], np.float32))
    mass = dict(mass=0.37, center_of_mass=rng.random(3), inertia_diagonal=rng.random(3),
                inertia_orientation=np.array([1.0, 0.0, 0.0, 0.0]))
    return fields, mass


@pytest.mark.parametrize("case", ["float64", "int64-tris", "no-excite", "quality"])
def test_hash_solve_inputs_digest_equals_reference(case):
    rng = np.random.default_rng(11)
    pts = rng.random((17, 3))
    tris = rng.integers(0, 17, (30, 3)).astype(np.int64 if case == "int64-tris" else np.uint32)
    excite = np.zeros((0, 3)) if case == "no-excite" else pts[:3]
    kwargs = dict(quality_tets=True, solve_resolution=0.5) if case == "quality" else {}
    args = (pts, tris, excite, (1.0, 2.0, 3.0))
    digest = orchestration.hash_solve_inputs(*args, **kwargs)
    assert digest == ref_orch.hash_solve_inputs(*args, **kwargs)
    assert len(digest) == 32
    assert digest != orchestration.hash_solve_inputs(pts + 1e-12, *args[1:], **kwargs)


def test_model_store_key_and_bytes_equal_reference(tmp_path):
    fields, mass = _seeded_model()
    modes, mp = ModalModes(**fields), MassProperties(**mass)
    rmodes, rmp = ref_types.ModalModes(**fields), ref_types.MassProperties(**mass)
    assert model_store.modal_model_key(modes, mp) == ref_store.modal_model_key(rmodes, rmp)
    path = model_store.save_modal_model(tmp_path / "port", modes, mp)
    rpath = ref_store.save_modal_model(tmp_path / "ref", rmodes, rmp)
    assert path.name == rpath.name
    assert path.read_bytes() == rpath.read_bytes()
    # Write-once: a second save of the same model leaves the file alone.
    stamp = path.stat().st_mtime_ns
    assert model_store.save_modal_model(tmp_path / "port", modes, mp) == path
    assert path.stat().st_mtime_ns == stamp
    # Each package loads the other's file.
    got, got_mp = model_store.load_modal_model(rpath)
    rgot, rgot_mp = ref_store.load_modal_model(path)
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(rgot, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(modes, f), err_msg=f)
    assert got.original_fundamental_freq == rgot.original_fundamental_freq
    assert got_mp.mass == rgot_mp.mass == mass["mass"]
    for f in ("center_of_mass", "inertia_diagonal", "inertia_orientation"):
        np.testing.assert_array_equal(getattr(got_mp, f), getattr(rgot_mp, f))


def test_convert_carries_a_reference_model_into_the_port(tmp_path):
    fields, mass = _seeded_model(seed=8)
    rmodes, rmp = ref_types.ModalModes(**fields), ref_types.MassProperties(**mass)
    modes, mp = convert.from_reference(rmodes), convert.from_reference(rmp)
    assert type(modes) is ModalModes and type(mp) is MassProperties
    assert model_store.modal_model_key(modes, mp) == ref_store.modal_model_key(rmodes, rmp)
    assert modes.shapes is not rmodes.shapes  # a copy, not a view of the reference's state


@pytest.fixture(scope="module")
def torus_solves():
    """The drive recipe's torus at a small lattice through both packages."""
    pts, tris = torus_surface(0.06, 0.025, 24, 12)
    kw = dict(num_modes=12, num_vertices=6, max_mode_freq=48000.0)
    counts = (cdt.NATIVE_MESHES, voxel_tets.VOXEL_MESHES, lobpcg.HOST_SOLVES)
    port = api.solve_surface(pts, tris, GLASS.properties, settings=ModalSolveSettings(**kw),
                             tet_resolution=8, device="cpu")
    moved = (cdt.NATIVE_MESHES - counts[0], voxel_tets.VOXEL_MESHES - counts[1],
             lobpcg.HOST_SOLVES - counts[2])
    ref = ref_api.solve_surface(pts, tris, ref_materials.GLASS.properties,
                                settings=ref_types.ModalSolveSettings(**kw), tet_resolution=8)
    return port, ref, moved


def test_solve_surface_matches_reference(torus_solves):
    port, ref, _moved = torus_solves
    assert port.profile.dofs == ref.profile.dofs == 8127  # the same mesh, the same pencil
    assert port.modes.num_modes == ref.modes.num_modes == 12
    lam, rlam = port.summary.eigenvalues, np.asarray(ref.summary.eigenvalues)
    assert np.abs(np.sqrt(lam[6:] / rlam[6:]) - 1).max() < HOST_PATH_RTOL  # float64 frequencies
    assert np.abs(port.modes.freqs / np.asarray(ref.modes.freqs) - 1).max() < STORED_RTOL
    assert np.abs(port.modes.t60s / np.asarray(ref.modes.t60s) - 1).max() < STORED_RTOL
    assert 4e3 < port.modes.freqs[0] < 7e3  # a 6 cm glass torus rings in the kHz
    np.testing.assert_array_equal(port.modes.positions, np.asarray(ref.modes.positions))
    np.testing.assert_array_equal(port.modes.baked_scale, np.asarray(ref.modes.baked_scale))
    assert port.mass_props.mass == pytest.approx(ref.mass_props.mass, rel=1e-12)
    np.testing.assert_array_equal(port.sample_point_of_excitation,
                                  np.asarray(ref.sample_point_of_excitation))


def test_solve_surface_counts_the_mesher_and_the_solver(torus_solves):
    _port, _ref, (native, voxel, host) = torus_solves
    assert (native, voxel, host) == (1, 0, 1)


def test_solve_surface_simplifies_first_when_asked():
    pts, tris = torus_surface(0.06, 0.025, 24, 12)
    from mesheditor_tpu_torch import profile

    profile.reset()
    profile.enabled = True
    try:
        res = api.solve_surface(
            pts, tris, GLASS.properties, tet_resolution=6, device="cpu",
            settings=ModalSolveSettings(num_modes=6, num_vertices=4, max_mode_freq=48000.0,
                                        solve_resolution=0.5))
        totals = profile.totals()
    finally:
        profile.enabled = False
        profile.reset()
    assert res.modes.num_modes > 0
    # The host path (n <= small_n): mesh2modes's stage spans, no eigensolver iteration.
    assert set(totals) == {"solve/simplify", "solve/tetrahedralize", "solve/mesh2modes",
                           "solve/mesh2modes/solve/assemble", "solve/mesh2modes/solve/amg",
                           "solve/mesh2modes/solve/eigs"}
    assert all(count == 1 and seconds > 0 for count, seconds in totals.values())


def test_surface_the_delaunay_mesher_refuses_falls_to_voxels():
    """One triangle short of closed: the Delaunay mesher's watertight gate refuses it with
    a ValueError, the voxel mesher (ray parity) still fills it, and the solve goes on: the
    reference's fallback, kept for meshing failures and counted."""
    p, t = icosphere_surface(1)
    counts = (cdt.NATIVE_MESHES, voxel_tets.VOXEL_MESHES)
    res = api.solve_surface(
        p * 0.03, t[:-1], GLASS.properties, tet_resolution=6, device="cpu",
        settings=ModalSolveSettings(num_modes=6, num_vertices=4, max_mode_freq=2e5))
    assert (cdt.NATIVE_MESHES, voxel_tets.VOXEL_MESHES) == (counts[0], counts[1] + 1)
    assert res.modes.num_modes > 0
    ref = ref_api.solve_surface(
        p * 0.03, t[:-1], ref_materials.GLASS.properties, tet_resolution=6,
        settings=ref_types.ModalSolveSettings(num_modes=6, num_vertices=4, max_mode_freq=2e5))
    assert res.profile.dofs == ref.profile.dofs  # the same voxel mesh
    # The sphere's modes come in multiplets that the mesh splits by ~1e-6; two shift-invert
    # solves place the members of one that far apart (measured 1.8e-6), so 1e-5 here.
    assert np.abs(res.modes.freqs / np.asarray(ref.modes.freqs) - 1).max() < 1e-5


def test_open_surface_is_diagnosed_by_its_boundary():
    """Half a sphere: neither mesher finds an interior, and the error names the cause."""
    p, t = icosphere_surface(1)
    counts = (cdt.NATIVE_MESHES, voxel_tets.VOXEL_MESHES)
    with pytest.raises(ValueError, match=r"surface is not closed \(\d+ boundary half-edges\)"):
        api.solve_surface(p * 0.03, t[: len(t) // 2], GLASS.properties, tet_resolution=6,
                          device="cpu")
    assert (cdt.NATIVE_MESHES, voxel_tets.VOXEL_MESHES) == counts


def test_padded_solve_matches_unpadded():
    # A 4 x 3 cm section: a square one has degenerate bending pairs, and a pair split by
    # the solved-column count makes repeated ARPACK solves of this one pencil move by up
    # to 7e-8 in frequency (measured over 150 pairs), against 1e-10 here.
    mesh = bar_tets(0.2, 0.04, 0.03, 4, 2, 2)
    cfg = SolverConfig(num_modes=8, num_fem_modes=12)
    base = mesh2modes(mesh, CERAMIC.properties, mesh.points[:3], config=cfg, device="cpu")
    padded = batch.pad_tetmesh(mesh, mesh.points.shape[0] + 37, mesh.tets.shape[0] + 101)
    assert padded.points.shape[0] == mesh.points.shape[0] + 37
    alt = mesh2modes(padded, CERAMIC.properties, mesh.points[:3], config=cfg, device="cpu")
    assert alt.modes.num_modes == base.modes.num_modes > 0
    lam, base_lam = alt.summary.eigenvalues[6:], base.summary.eigenvalues[6:]
    assert np.abs(np.sqrt(lam / base_lam) - 1).max() < HOST_PATH_RTOL  # float64 frequencies
    assert np.abs(alt.modes.freqs / base.modes.freqs - 1).max() < STORED_RTOL
    assert alt.mass_props.mass == pytest.approx(base.mass_props.mass, rel=1e-12)
    with pytest.raises(ValueError, match="exceeds bucket"):
        batch.pad_tetmesh(mesh, 4, 4)


def test_batch_solve_streams_into_the_store_and_resumes(tmp_path):
    a, b = bar_tets(0.2, 0.04, 0.04, 3, 2, 2), bar_tets(0.22, 0.04, 0.04, 5, 2, 2)
    items = [batch.CorpusItem("bar_ceramic", a, CERAMIC.properties, a.points[:2]),
             batch.CorpusItem("bar_glass", b, GLASS.properties, b.points[:2]),
             batch.CorpusItem("bar_glass_small", a, GLASS.properties, a.points[:2])]
    cfg = SolverConfig(num_modes=6, num_fem_modes=10)
    seen = []
    first = batch.batch_solve(items, tmp_path, cfg, point_bucket=40, tet_bucket=100,
                              progress=seen.append, device="cpu")
    # Two buckets; the smaller bucket's items come first, in the order given.
    assert [r.name for r in first] == ["bar_ceramic", "bar_glass_small", "bar_glass"]
    assert seen == first
    assert len({r.path for r in first}) == 3 and all(r.path.exists() for r in first)
    assert all(r.num_modes > 0 and r.f1_hz > 0 and r.solve_seconds > 0 for r in first)
    for r in first:
        modes, _mass = model_store.load_modal_model(r.path)
        assert modes.num_modes == r.num_modes and float(modes.freqs[0]) == r.f1_hz
    files = sorted(p.name for p in tmp_path.iterdir())
    # An interrupted run: one model is gone. The rerun solves that item and no other.
    first[2].path.unlink()
    solves = lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES
    again = batch.batch_solve(items, tmp_path, cfg, point_bucket=40, tet_bucket=100,
                              device="cpu")
    assert lobpcg.HOST_SOLVES + lobpcg.DEVICE_SOLVES == solves + 1
    assert [(r.name, r.num_modes, r.f1_hz, r.iterations) for r in again[:2]] == \
        [(r.name, r.num_modes, r.f1_hz, r.iterations) for r in first[:2]]
    assert [r.solve_seconds > 0 for r in again] == [False, False, True]
    assert again[2].f1_hz == pytest.approx(first[2].f1_hz, rel=STORED_RTOL)
    assert len(list(tmp_path.iterdir())) >= len(files)
    # A different request (another config) is not answered from the index.
    other = batch.batch_solve(items[:1], tmp_path, SolverConfig(num_modes=5, num_fem_modes=10),
                              point_bucket=40, tet_bucket=100, device="cpu")
    assert other[0].solve_seconds > 0 and other[0].num_modes <= 5
    # The index key names every material and solver field: an equal request built anew
    # keys the same, and one changed field of either keys differently.
    key = batch._request_key(items[0], cfg)
    same = batch.CorpusItem("renamed", a, replace(CERAMIC.properties), a.points[:2].copy())
    assert batch._request_key(same, SolverConfig(num_modes=6, num_fem_modes=10)) == key
    denser = replace(CERAMIC.properties, density=CERAMIC.properties.density * 1.01)
    assert batch._request_key(replace(items[0], material=denser), cfg) != key
    assert batch._request_key(items[0], replace(cfg, tolerance=cfg.tolerance * 2)) != key


def test_batch_solve_answers_match_reference(tmp_path):
    from mesheditor_tpu.mesh import bar_tets as ref_bar_tets
    from mesheditor_tpu.solve import batch as ref_batch

    mesh, rmesh = bar_tets(0.2, 0.04, 0.04, 3, 2, 2), ref_bar_tets(0.2, 0.04, 0.04, 3, 2, 2)
    cfg = dict(num_modes=6, num_fem_modes=10)
    got = batch.batch_solve(
        [batch.CorpusItem("bar", mesh, CERAMIC.properties, mesh.points[:2])],
        tmp_path / "port", SolverConfig(**cfg), point_bucket=64, tet_bucket=128, device="cpu")
    ref = ref_batch.batch_solve(
        [ref_batch.CorpusItem("bar", rmesh, ref_materials.CERAMIC.properties,
                              rmesh.points[:2])],
        tmp_path / "ref", ref_types.SolverConfig(**cfg), point_bucket=64, tet_bucket=128)
    assert got[0].num_modes == ref[0].num_modes
    assert got[0].f1_hz == pytest.approx(ref[0].f1_hz, rel=STORED_RTOL)
    a, _ = model_store.load_modal_model(got[0].path)
    b, _ = model_store.load_modal_model(ref[0].path)  # the port reads the reference's store
    assert np.abs(a.freqs / b.freqs - 1).max() < STORED_RTOL


@pytest.mark.parametrize("f0,n", [(440.0, 4096), (1234.5, 8192), (3000.0, 200)])
def test_estimate_fundamental_equals_reference(f0, n):
    t = np.arange(n) / 48_000.0
    x = np.sin(2 * np.pi * f0 * t) * np.exp(-3 * t) + 0.2 * np.sin(2 * np.pi * 2.7 * f0 * t)
    got = orchestration.estimate_fundamental(x)
    assert got == ref_orch.estimate_fundamental(x)
    if n >= 256:
        assert abs(got - f0) < 48_000.0 / n
    else:
        assert got == 0.0


def test_staleness_and_warm_start_memo_follow_reference():
    fp = orchestration.SolvedFingerprint("abc", 30, 20.0, 16000.0, 0.2)
    rfp = ref_orch.SolvedFingerprint("abc", 30, 20.0, 16000.0, 0.2)
    for h, cfg_kw, nu in [("abc", {}, 0.2), ("abd", {}, 0.2), ("abc", {"num_modes": 31}, 0.2),
                          ("abc", {}, 0.21), ("abc", {"max_mode_freq": 8000.0}, 0.2)]:
        stale = orchestration.modal_model_stale(fp, h, SolverConfig(**cfg_kw), nu)
        assert stale == ref_orch.modal_model_stale(rfp, h, ref_types.SolverConfig(**cfg_kw), nu)
        assert stale == (h != "abc" or bool(cfg_kw) or nu != 0.2)
    warm = orchestration.ModalWarmStart()
    assert warm.lookup("abc") is None
    warm.offer("abc", np.ones((6, 2), np.float32))
    warm.offer("abd", None)  # an empty offer does not evict the slot
    assert warm.lookup("abc") is not None and warm.lookup("abd") is None


def test_retuned_modes_equal_reference():
    from mesheditor_tpu.synth import tuning as ref_tuning
    from mesheditor_tpu_torch.synth import tuning
    from mesheditor_tpu_torch.types import ModalTuning

    fields, _mass = _seeded_model(seed=9)
    modes, rmodes = ModalModes(**fields), ref_types.ModalModes(**fields)
    for tune, scale in [((0.0, 1.0), 1.0), ((880.0, 0.5), 1.0), ((0.0, 2.0), 2.5)]:
        f, t = tuning.retuned_modes(modes, ModalTuning(*tune), scale)
        rf, rt = ref_tuning.retuned_modes(rmodes, ref_types.ModalTuning(*tune), scale)
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(t, rt)
    assert tuning.mass_normalized_gain(0.5, 12, 2.0) == ref_tuning.mass_normalized_gain(0.5, 12, 2.0)
