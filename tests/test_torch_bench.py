"""The port's headline benchmark (mesheditor_tpu_torch/bench.py) against the reference's
bench.py on the CPU: the golden render against the JAX package's, `run` on a small box and a
coarse torus (its report and detail keys against bench.py's, its solve against the JAX
package's mesh2modes on the same box), and the `bench` and `warmup --set bench` commands
reaching `run`."""

import ast
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch import bench as port_bench

ROOT = Path(__file__).resolve().parent.parent
SMALL_BOX = (4, 2, 2)
TORUS = dict(torus_lattice=4, torus_segments=(16, 8))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def reference_bench():
    """The repo-root bench.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location("reference_bench", ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_keys():
    """The keys of bench.py's report line and of its detail line (the CDT case's keys as
    its success branch writes them), read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    dicts = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], ast.Name)):
            keys = [k.value for k in node.value.keys if isinstance(k, ast.Constant)]
            if keys and "cdt_error" not in keys:
                dicts[node.targets[0].id] = keys
    return dicts["report"], dicts["detail"] + dicts["cdt"]


@pytest.fixture(scope="module")
def bench_run():
    """`run(report_json=True, device="cpu")` on the small box and the coarse torus: the
    returned (report, detail) and what it printed on stdout and stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        report, detail = port_bench.run(report_json=True, device="cpu",
                                        box_resolution=SMALL_BOX, **TORUS)
    return report, detail, out.getvalue(), err.getvalue()


def test_golden_render_rms_matches_the_reference():
    rms = port_bench._golden_render_rms(48_000.0, "cpu")
    ref = reference_bench()._golden_render_rms(48_000.0)
    assert port_bench.RMS_BAND[0] <= rms <= port_bench.RMS_BAND[1]
    np.testing.assert_allclose(rms, ref, rtol=1e-4)


def test_report_and_detail_keep_the_reference_keys(bench_run):
    report, detail, stdout, stderr = bench_run
    report_keys, detail_keys = reference_keys()
    last = json.loads(stdout.strip().splitlines()[-1])
    assert last == report and list(last) == report_keys
    assert last["metric"] == "eigensolve_10ktet_256modes_plus_render_64obj_1s"
    assert last["unit"] == "x_realtime" and last["value"] > 0
    printed = json.loads(stderr.strip().splitlines()[-1])
    assert printed == detail
    renamed = ["kernel_parity" if k == "pallas_parity" else k for k in detail_keys]
    assert list(detail) == renamed + ["card"]
    assert detail["card"] == "cpu"
    assert detail["kernel_parity"] == 0.0  # both synths on the CPU: the same plain version
    assert port_bench.RMS_BAND[0] <= detail["golden_render_rms"] <= port_bench.RMS_BAND[1]
    assert detail["cdt_modes"] > 0 and detail["cdt_dofs"] > 0


def test_solve_matches_the_reference_mesh2modes(bench_run):
    """f1 and the mode count of the port's timed solve against the JAX package's mesh2modes
    on the same box, config and excitation points."""
    from mesheditor_tpu import SolverConfig, mesh2modes
    from mesheditor_tpu.materials import CERAMIC
    from mesheditor_tpu.mesh import box_tets

    _report, detail, _out, _err = bench_run
    mesh = box_tets((0.3, 0.16, 0.15), SMALL_BOX)
    cfg = SolverConfig(num_modes=256, num_fem_modes=256, max_mode_freq=48_000.0,
                       tolerance=1e-6)
    excite = mesh.points[:: max(mesh.points.shape[0] // 10, 1)][:10]
    ref = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg)
    assert detail["dofs"] == ref.profile.dofs
    assert detail["modes"] == ref.modes.num_modes
    np.testing.assert_allclose(detail["f1_hz"], float(ref.modes.freqs[0]), rtol=1e-6)


def test_torus_case_matches_the_reference_mesher_and_solve(bench_run):
    """The CDT case: the same Delaunay mesh (one mesher source) and f1 as the JAX package's
    mesh2modes on it."""
    from mesheditor_tpu import SolverConfig, mesh2modes
    from mesheditor_tpu.materials import CERAMIC
    from mesheditor_tpu.mesh import torus_surface
    from mesheditor_tpu.mesh.cdt import generate_tets_delaunay

    _report, detail, _out, _err = bench_run
    pts, tris = torus_surface(0.06, 0.025, *TORUS["torus_segments"])
    h = float(np.max(pts.max(0) - pts.min(0))) / TORUS["torus_lattice"]
    tmesh = generate_tets_delaunay(pts, tris, lattice_h=h)
    port_mesh = port_bench.torus_mesh(**{"lattice": TORUS["torus_lattice"],
                                         "segments": TORUS["torus_segments"]})
    np.testing.assert_array_equal(port_mesh.tets, tmesh.tets)
    ex = tmesh.points[:: max(tmesh.points.shape[0] // 10, 1)][:10]
    ref = mesh2modes(tmesh, CERAMIC.properties, ex,
                     config=SolverConfig(num_modes=30, num_fem_modes=45))
    assert detail["cdt_dofs"] == ref.profile.dofs
    assert detail["cdt_modes"] == ref.modes.num_modes
    np.testing.assert_allclose(detail["cdt_f1_hz"], float(ref.modes.freqs[0]), rtol=1e-6)


def test_bench_and_warmup_bench_reach_run(monkeypatch):
    """`bench --device` and `warmup --set bench` both go through bench.run (the reference's
    `bench` runs bench.py, and its warmup's bench set calls bench.run(report_json=False))."""
    import mesheditor_tpu_torch.__main__ as cli

    calls = []

    def fake_run(report_json=True, device="cuda"):
        calls.append((report_json, str(device)))
        return {}, {"modes": 1, "f1_hz": 1.0, "dofs": 3}

    monkeypatch.setattr(port_bench, "run", fake_run)
    monkeypatch.setattr(cli, "_warm_quickstart", lambda device: None)
    monkeypatch.setattr("mesheditor_tpu_torch._build.load_tetmesher", lambda: None)
    cli.main(["bench", "--device", "cpu"])
    cli.main(["warmup", "--set", "bench", "--device", "cpu"])
    assert calls == [(True, "cpu"), (False, "cpu")]


def test_bench_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        port_bench.run(device="cuda")


def test_the_bench_tools_import_no_reference_tool():
    """bench.py's port, the port's scripts and chip_smoke.py import neither the repo-root
    bench.py nor scripts/ (test_torch_package.py holds them to no JAX)."""
    banned = ("bench", "scripts")
    files = [ROOT / "mesheditor_tpu_torch" / "bench.py", ROOT / "chip_smoke.py",
             *sorted((ROOT / "mesheditor_tpu_torch" / "scripts").glob("*.py"))]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path.name} imports {name}"
