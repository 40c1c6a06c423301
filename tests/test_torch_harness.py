"""The scanned-object tools of the port (mesheditor_tpu_torch/scripts/) against the JAX
package's scripts/ on the CPU: the mesher's structural snapshot from the port's own build
against tests/fixtures/tet_corpus_snapshot.txt, the RealImpact scan double, the
RealImpact harness on a double written by the JAX script, and the device eigensolver's
check against scipy. The snapshot's iso-surface rows are slow, as in
tests/test_native_mesher.py."""

import contextlib
import importlib.util
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch.io import read_wav
from mesheditor_tpu_torch.scripts import (check_eigensolver, make_realimpact_double,
                                          realimpact_harness, tet_corpus_snapshot)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "tet_corpus_snapshot.txt"
TINY = dict(radius=0.05, thickness=0.004, n_lat=5, n_lon=12, noise=0.05)  # test_realimpact_batch
TINY_DOUBLE = dict(frames=4800, tet_resolution=6, n_modes=10, bowl_kw=TINY, seed=3)
HARNESS_TET_RESOLUTION = 6


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


@contextlib.contextmanager
def seeded_arpack():
    """scipy's eigsh, where no start vector is given, started from the port's fixed one
    (seed 0). The JAX script leaves ARPACK its own random start, which moves the answer by
    up to ~1e-7 relative between calls and may turn a near-degenerate pair; started alike,
    the two scripts do the same arithmetic on the same pencil."""
    import scipy.sparse.linalg as spla

    eigsh = spla.eigsh

    def seeded(a, *args, v0=None, **kwargs):
        if v0 is None:
            v0 = np.random.default_rng(0).uniform(-1.0, 1.0, a.shape[0])
        return eigsh(a, *args, v0=v0, **kwargs)

    spla.eigsh = seeded
    try:
        yield
    finally:
        spla.eigsh = eigsh


def _fixture(iso: bool):
    lines = FIXTURE.read_text().strip().splitlines()
    return [line for line in lines if line.startswith("iso_") == iso]


# ---- tet_corpus_snapshot ----


def test_snapshot_rows_match_the_fixture():
    """Every non-iso row (27: primitives, thin shells, soup) from the port's mesher build."""
    want = _fixture(iso=False)
    got = list(tet_corpus_snapshot.snapshot_lines(include=lambda n: not n.startswith("iso_")))
    assert len(want) == 27
    assert got == want


def test_snapshot_corpus_is_the_reference_corpus():
    ref = reference_script("tet_corpus_snapshot")
    port_cases, ref_cases = list(tet_corpus_snapshot.corpus()), list(ref.corpus())
    assert [n for n, _ in port_cases] == [n for n, _ in ref_cases]
    for (name, (p, t)), (_, (rp, rt)) in zip(port_cases, ref_cases):
        np.testing.assert_array_equal(p, rp, err_msg=name)
        np.testing.assert_array_equal(t, rt, err_msg=name)


@pytest.mark.slow
def test_snapshot_iso_rows_match_the_fixture():
    got = list(tet_corpus_snapshot.snapshot_lines(include=lambda n: n.startswith("iso_")))
    assert got == _fixture(iso=True)


# ---- make_realimpact_double ----


@pytest.fixture(scope="module")
def doubles(tmp_path_factory):
    """The same tiny double written by the port's script and by the JAX script (its ARPACK
    started from the port's vector)."""
    root = tmp_path_factory.mktemp("doubles")
    port = make_realimpact_double.make_double(root / "port", name="1_CeramicKoiBowl",
                                              **TINY_DOUBLE)
    with seeded_arpack():
        ref = reference_script("make_realimpact_double").make_double(
            root / "ref", name="1_CeramicKoiBowl", **TINY_DOUBLE)
    return port, ref


def test_scipy_reference_modes_match_the_reference():
    """The same mesh (tets and points) and frequencies within 1e-8 relative, the JAX
    script's ARPACK started from the port's vector."""
    from mesheditor_tpu.materials import find_material as jax_find_material
    from mesheditor_tpu.mesh import bowl_surface as jax_bowl_surface

    from mesheditor_tpu_torch.materials import find_material
    from mesheditor_tpu_torch.mesh import bowl_surface

    ref = reference_script("make_realimpact_double")
    pts, tris = bowl_surface(seed=3, **TINY)
    rpts, rtris = jax_bowl_surface(seed=3, **TINY)
    np.testing.assert_array_equal(pts, rpts)
    np.testing.assert_array_equal(tris, rtris)
    tm, freqs, _, vecs, quad = make_realimpact_double.scipy_reference_modes(
        pts, tris, find_material("Ceramic").properties, tet_resolution=6, n_modes=10)
    with seeded_arpack():
        rtm, rfreqs, _, _, _ = ref.scipy_reference_modes(
            rpts, rtris, jax_find_material("Ceramic").properties, tet_resolution=6,
            n_modes=10)
    np.testing.assert_array_equal(tm.tets, rtm.tets)
    np.testing.assert_array_equal(tm.points, rtm.points)
    assert freqs.size == rfreqs.size == 10
    np.testing.assert_allclose(freqs, rfreqs, rtol=1e-8)
    assert vecs.shape == (3 * quad.node_count, 10)


def test_double_matches_the_reference(doubles):
    """Every array of the object directory equal, the mesh file equal, the recordings
    within 1e-4 of their peak."""
    port, ref = doubles
    pre, rpre = port / "preprocessed", ref / "preprocessed"
    names = sorted(p.name for p in rpre.iterdir())
    assert sorted(p.name for p in pre.iterdir()) == names
    for name in names:
        if name == "deconvolved_0db.npy":
            a, b = np.load(pre / name), np.load(rpre / name)
            assert a.shape == b.shape == (3000, 4800) and a.dtype == b.dtype == np.float32
            assert np.abs(a - b).max() < 1e-4 * np.abs(b).max()
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pre / name), np.load(rpre / name),
                                          err_msg=name)
        else:
            assert (pre / name).read_bytes() == (rpre / name).read_bytes(), name


# ---- realimpact_harness ----


IMPACT_LINE = re.compile(r"impact (\d): f0=\s*([\d.]+) Hz match (\d+)/(\d+) partials")


def _impacts(text):
    return [(int(i), float(f0), int(h), int(n)) for i, f0, h, n in IMPACT_LINE.findall(text)]


@pytest.fixture(scope="module")
def reference_run(doubles, tmp_path_factory):
    """The JAX script's run_object on the JAX-written double, its host solve's ARPACK
    started from the port's vector (a near-degenerate pair of the bowl otherwise turns with
    the start, and with it which partials a strike rings loudest): (score, printed text)."""
    import io

    ref = reference_script("realimpact_harness")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), seeded_arpack():
        score = ref.run_object(doubles[1], 263, 60.0, str(tmp_path_factory.mktemp("ref_wavs")),
                               HARNESS_TET_RESOLUTION)
    return score, out.getvalue()


def test_run_object_matches_the_reference(doubles, reference_run, tmp_path, capsys):
    """On the double the JAX script wrote, the port's run_object gives the JAX script's
    f0 per impact (within 0.1 Hz), partial counts and score, and writes the wav pair of
    each impact, which reads back."""
    ref_score, ref_text = reference_run
    capsys.readouterr()
    score = realimpact_harness.run_object(doubles[1], 263, 60.0, str(tmp_path),
                                          HARNESS_TET_RESOLUTION, device="cpu")
    text = capsys.readouterr().out
    got, want = _impacts(text), _impacts(ref_text)
    assert len(got) == len(want) == 5
    for (i, f0, hits, n), (ri, rf0, rhits, rn) in zip(got, want):
        assert i == ri and abs(f0 - rf0) < 0.1 and f0 > 0
        assert (hits, n) == (rhits, rn), (i, hits, n, rhits, rn)
    assert score == ref_score
    assert re.search(r"solve: \d+ dofs, \d+ iterations, answered by host, \d+ modes", text)
    assert "impact kernel launches: 0" in text  # the CPU renders take the plain version
    for imp in range(5):  # 0.1 s of recording; the render rounds up to whole blocks of 512
        for kind, size in (("modal", 5_120), ("recorded", 4_800)):
            audio, rate = read_wav(tmp_path / f"CeramicKoiBowl_{imp}_{kind}.wav")
            assert rate == 48_000 and audio.size == size and np.isfinite(audio).all()
            assert 0 < np.abs(audio).max() <= 1.0


def test_main_on_a_missing_dataset_skips(tmp_path, capsys):
    assert realimpact_harness.main(["--dataset", str(tmp_path / "nowhere"),
                                    "--device", "cpu"]) == {}
    assert "RealImpact dataset not found; skipping" in capsys.readouterr().out


def test_cuda_without_a_card_raises(doubles):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        realimpact_harness.main(["--dataset", str(doubles[0].parent)])
    with pytest.raises(RuntimeError, match="cuda"):
        realimpact_harness.main(["--dataset", str(doubles[0].parent), "--device", "cuda"])


def test_a_mesher_error_is_reported_and_any_other_error_propagates(doubles, tmp_path,
                                                                   monkeypatch, capsys):
    """Over two objects, a mesher ValueError on the first is reported and the second still
    runs; a RuntimeError (what a failed kernel build or CUDA call raises) ends the run."""
    from mesheditor_tpu_torch import api

    root = tmp_path / "two"
    for name in ("1_CeramicKoiBowl", "2_CeramicKoiBowl"):
        shutil.copytree(doubles[0], root / name)
    solve = api.solve_surface
    calls = []

    def first_unmeshable(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("tetrahedralization failed: surface is not closed")
        return solve(*args, **kwargs)

    monkeypatch.setattr(api, "solve_surface", first_unmeshable)
    results = realimpact_harness.main(["--dataset", str(root), "--device", "cpu",
                                       "--tet-resolution", str(HARNESS_TET_RESOLUTION)])
    text = capsys.readouterr().out
    assert "1_CeramicKoiBowl: FAILED tetrahedralization failed" in text
    assert list(results) == ["2_CeramicKoiBowl"] and len(calls) == 2
    assert "mean partial-match score:" in text

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(api, "solve_surface", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        realimpact_harness.main(["--dataset", str(root), "--device", "cpu"])


# ---- check_eigensolver ----


def test_check_eigensolver_on_the_cpu():
    """--amg: the device engine (small_n=0) on the 8x2x2 bar against scipy: the same
    audible frequencies, far inside 0.1%; the six rigid modes are the deflated exact
    zeros."""
    out = check_eigensolver.check((8, 2, 2), 20, 24, device="cpu", amg=True)
    assert out["n_dofs"] == 1275 and out["got_hz"] is not None and out["engine"] == "amg"
    assert len(out["got_hz"]) == len(out["ref_hz"]) == 14
    assert out["max_rel_err"] < 1e-6
    assert out["rigid"] == [0.0] * 6


@pytest.mark.parametrize("f32", [False, True])
def test_check_eigensolver_default_is_the_closure_engine(f32):
    """The script's default, as the reference's script: the closure engine on the bar's
    operator callables, Jacobi CG in float64 (or, with f32, CG on the float32 sparse copies
    of the pencil), settled in 7 +- 2 iterations with 3 + 50 panels an iteration, the same
    audible frequencies as scipy within 1e-6, and rigid eigenvalues of its own (not the
    deflated zeros) under 1e-6 of the first elastic one."""
    out = check_eigensolver.check((8, 2, 2), 20, 24, device="cpu", f32=f32)
    assert out["engine"] == ("closure, float32 pencil" if f32 else "closure, Jacobi")
    assert len(out["got_hz"]) == len(out["ref_hz"]) == 14
    assert abs(out["iterations"] - 7) <= 2
    assert out["op_applications"] == 3 + out["iterations"] * 50
    assert out["max_rel_err"] < 1e-6
    rigid = np.abs(out["rigid"])
    assert rigid.max() > 0 and rigid.max() < 1e-6 * (2 * np.pi * out["got_hz"][0]) ** 2
