"""The PyTorch port as a package: it imports with JAX blocked, imports nothing of JAX or
the JAX package, and never quietly runs on the CPU when a CUDA device is asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mesheditor_tpu_torch
from mesheditor_tpu_torch.api import make_synth
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import bar_tets
from mesheditor_tpu_torch.synth import impact
from mesheditor_tpu_torch.types import ModalModes

PKG = Path(mesheditor_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_imports_with_jax_blocked():
    """Every module of the package, `__main__` included, imports with JAX out of reach and
    pulls in nothing of JAX or of the JAX package."""
    code = (
        "import importlib, pkgutil, sys; sys.modules['jax'] = None\n"
        "import mesheditor_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "need = ['__main__', 'api', 'profile', 'mesh.cdt', 'mesh.simplify', 'mesh.voxel_tets',"
        " 'mesh.isosurface', 'mesh.halfedge', 'solve.batch', 'solve.orchestration',"
        " 'io.model_store', 'synth.tuning', 'scene.audio_sync', 'scene.registry',"
        " 'scene.animation', 'scene.armature', 'physics.world', 'physics.scene_build',"
        " 'render', 'render.camera', 'render.raster', 'render.shading', 'render.environment',"
        " 'render.picking', 'render.scene_render', 'render.selection_state', 'render.gizmo',"
        " 'render.debug_draw', 'render.record', 'io.gltf', 'io.project', 'io.realimpact',"
        " 'io.realimpact_harness', 'scene.actions', 'scene.field_edit', 'scene.log',"
        " 'scene.session', 'scene.snapshot', 'scene.timeline', 'app', 'app.viewer', 'app.page',"
        " 'viz', 'parallel', 'parallel.sharding', 'parallel.launch', 'parallel.dryrun',"
        " 'bench', 'scripts', 'scripts.render_bench', 'scripts.edit_loop_bench',"
        " 'scripts.cdt_bench', 'scripts.realimpact_batch', 'scripts.tet_corpus_snapshot',"
        " 'scripts.make_realimpact_double', 'scripts.check_eigensolver',"
        " 'scripts.realimpact_harness', 'scripts.diag_cdt_solve']\n"
        "missing = [n for n in need if pkg.__name__ + '.' + n not in names]\n"
        "assert not missing, missing\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and (m == 'mesheditor_tpu'"
        " or m.startswith(('mesheditor_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_jax_or_reference():
    paths = [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(paths) > 50
    for module in ("app/__init__.py", "app/viewer.py", "app/page.py", "viz.py"):
        assert PKG / module in paths, module
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "mesheditor_tpu"), f"{path}: {name}"


def test_render_layer_imports_neither_jax_nor_the_reference():
    """The 11 modules of the render layer, and what they import when loaded alone."""
    render = sorted((PKG / "render").glob("*.py"))
    assert [p.stem for p in render] == [
        "__init__", "camera", "debug_draw", "environment", "gizmo", "picking", "raster",
        "record", "scene_render", "selection_state", "shading"]
    for path in render:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] not in ("jax", "jaxlib", "mesheditor_tpu")
            elif isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] not in ("jax", "jaxlib", "mesheditor_tpu")
                           for a in node.names), path
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import mesheditor_tpu_torch.render as r, mesheditor_tpu_torch.render.gizmo, "
        "mesheditor_tpu_torch.render.debug_draw, mesheditor_tpu_torch.render.record, "
        "mesheditor_tpu_torch.render.selection_state, mesheditor_tpu_torch.render.environment\n"
        "import mesheditor_tpu_torch.io.gltf, mesheditor_tpu_torch.io.project, "
        "mesheditor_tpu_torch.io.realimpact_harness, mesheditor_tpu_torch.scene.session, "
        "mesheditor_tpu_torch.scene.timeline\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and (m == 'mesheditor_tpu'"
        " or m.startswith(('mesheditor_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=120)
    assert proc.returncode == 0, proc.stderr


# Names only the port exports, each with its reason. The reference's fem/cluster.py
# (macro clustering) and its pallas_* modules are TPU-forced designs that the port does not
# carry (ROADMAP Queue 1 item 2); none of their names is in the reference's `__all__`, so
# no reference name is excepted.
PORT_ONLY = {
    # The matrix-free shifted operator that the float64 solve applies on the card, where
    # the reference bakes a bf16 operator with fem/cluster.py.
    "fem": {"ShiftedElementOperator"},
    # The two kernels' wrappers and the block renders around them, the routes that
    # synth.render_block takes; tune_coeffs is the bank's retune without a rebuild.
    "synth": {"render_block_impacts", "render_block_coupled", "resonate", "resonate_coupled",
              "tune_coeffs"},
}


@pytest.mark.parametrize("sub", [
    "", "fem", "solve", "synth", "mesh", "physics", "render", "io", "scene", "app", "parallel",
])
def test_public_names_match_the_reference_package(sub):
    """Each subpackage (and the root, "") exports what the reference's `__init__` exports,
    plus the port-only names listed with their reasons, and every shared name resolves to an
    object of the reference's kind (a function for a function, jitted or not)."""
    import importlib

    port = importlib.import_module(".".join(filter(None, ["mesheditor_tpu_torch", sub])))
    ref = importlib.import_module(".".join(filter(None, ["mesheditor_tpu", sub])))
    extra = PORT_ONLY.get(sub, set())
    assert set(port.__all__) == set(ref.__all__) | extra
    assert not extra & set(ref.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    for name in ref.__all__:
        mine, theirs = getattr(port, name), getattr(ref, name)
        if callable(theirs) and not isinstance(theirs, type):
            # A jitted function there (jax.jit's PjitFunction) is a plain function here.
            assert callable(mine) and not isinstance(mine, type), name
        else:
            assert type(mine) is type(theirs), name


REF_PKG = REPO / "mesheditor_tpu"
# Public signatures that keep a difference from the reference's, by (module, name), with
# the reason. A port entry may also add a `device` parameter (the card unless the caller
# names the CPU); nothing else differs.
SIGNATURE_DIFFERENCES = {
    # PyTorch draws from an explicit torch.Generator where JAX splits a key from a seed.
    ("solve/amg.py", "spectral_seed"): "seed becomes generator",
    # The reference keeps float32 copies of the element blocks for the TPU's preconditioner
    # path; every block here is float64.
    ("fem/assembly.py", "assemble_element_matrices"): "no dtype",
    # The engine's internals: one float64 loop over the elastic spectrum with the
    # caller's deflation, where the reference's float32 stage takes sizes and the rigid
    # basis for its own.
    ("solve/eigs.py", "ortho_lobpcg"): "the engine's own arguments",
}


def public_signatures(path: Path) -> dict:
    """{name: [(parameter, kind), ...]} of a module's public functions and of its public
    classes' public methods and __init__, read from its source."""
    def params(fn):
        a = fn.args
        out = [(x.arg, "positional") for x in a.posonlyargs + a.args]
        out += [("*" + a.vararg.arg, "var")] if a.vararg else []
        out += [(x.arg, "keyword") for x in a.kwonlyargs]
        return out + ([("**" + a.kwarg.arg, "var")] if a.kwarg else [])

    def public(name):
        return not name.startswith("_") or name == "__init__"

    sigs = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and public(node.name):
            sigs[node.name] = params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            sigs.update({f"{node.name}.{f.name}": params(f) for f in node.body
                         if isinstance(f, ast.FunctionDef) and public(f.name)})
    return sigs


def test_public_signatures_match_the_reference_package():
    """Every public function and method that a module of the port shares with its
    counterpart in the reference takes the reference's parameters, by name, kind and
    order, apart from an added `device` and the differences listed with their reasons; each
    listed difference still exists."""
    kept, differ = set(), []
    for ref_path in sorted(REF_PKG.rglob("*.py")):
        rel = ref_path.relative_to(REF_PKG).as_posix()
        if not (PKG / rel).exists():
            continue
        ref, port = public_signatures(ref_path), public_signatures(PKG / rel)
        for name in sorted(set(ref) & set(port)):
            mine = [p for p in port[name] if p[0] != "device" or p in ref[name]]
            if mine == ref[name]:
                continue
            if (rel, name) in SIGNATURE_DIFFERENCES:
                kept.add((rel, name))
            else:
                differ.append((rel, name, ref[name], port[name]))
    assert not differ, differ
    assert kept == set(SIGNATURE_DIFFERENCES)


def test_viewer_and_viz_import_without_jax_or_matplotlib():
    """The viewer's modules and viz import with JAX and matplotlib both out of reach (viz
    imports matplotlib only when a function is called)."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['matplotlib'] = None\n"
        "import mesheditor_tpu_torch.viz, mesheditor_tpu_torch.app.viewer, "
        "mesheditor_tpu_torch.app.page\n"
        "from mesheditor_tpu_torch.app import ViewerApp, serve\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and (m == 'mesheditor_tpu'"
        " or m.startswith(('mesheditor_tpu.', 'jax', 'matplotlib')))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_precision_pins():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    mesh = bar_tets(0.1, 0.02, 0.02, 2, 1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        mesheditor_tpu_torch.mesh2modes(mesh, CERAMIC.properties, mesh.points[:1],
                                         device="cuda")
    modes = ModalModes(np.array([440.0]), np.array([0.5]), np.zeros((1, 1, 3), np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        make_synth([modes], device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        make_synth([modes])  # the default device is the card


def test_builders_default_to_the_card_and_raise_without_one():
    """assemble_element_matrices and build_bank default to the card, as mesh2modes does;
    TrackPool.empty, like the other tables' `empty`, takes no default device."""
    from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                          filter_degenerate)
    from mesheditor_tpu_torch.synth import TrackPool, build_bank

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    mesh = bar_tets(0.1, 0.02, 0.02, 2, 1, 1)
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    with pytest.raises(RuntimeError, match="cuda"):
        assemble_element_matrices(mesh.points, kept, CERAMIC.properties, quad)
    modes = ModalModes(np.array([440.0]), np.array([0.5]), np.zeros((1, 1, 3), np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        build_bank([modes])
    with pytest.raises(TypeError, match="device"):
        TrackPool.empty(2, 128)
    assert TrackPool.empty(2, 128, "cpu").heights.shape == (2, 128)


def test_cpu_render_takes_the_plain_version_and_counts_no_launch():
    modes = ModalModes(np.linspace(200, 2000, 8), np.full(8, 0.3),
                       np.full((1, 8, 3), 0.01, np.float32))
    synth = make_synth([modes], device="cpu")
    synth.strike(0, 0, (1.0, 0.0, 0.0), 0.002)
    before = impact.LAUNCHES
    out = synth.render(300)
    assert impact.LAUNCHES == before
    assert out.device.type == "cpu" and out.shape == (300,)
    assert torch.isfinite(out).all() and out.abs().max() > 0


def test_publish_voices_opens_keeps_and_ends_a_voice():
    from mesheditor_tpu_torch.synth import ContactTrackSpec, SustainedVoice, coupled
    from mesheditor_tpu_torch.synth.tracks import synthesize_roughness

    modes = ModalModes(np.linspace(200, 2000, 8), np.full(8, 0.3),
                       np.full((2, 8, 3), 0.01, np.float32))
    synth = make_synth([modes], device="cpu", max_voices=4)
    slot = synth.adopt_track(7, lambda: synthesize_roughness(2e-4, -2.0, 1e-6))
    voice = SustainedVoice(
        voice_id=42, obj=0, blend_points=(0, 1, 0), blend_weights=(0.5, 0.5, 0.0),
        normal=(0.0, 1.0, 0.0), slip_dir=(1.0, 0.0, 0.0),
        sweep_dir=((1.0, 0.0, 0.0), (0.0, 0.0, -1.0)), normal_force=4.0, friction=0.4,
        stiffness=2.0**28, static_penetration=2.0**-20, damping_coeff=0.3,
        tracks=(ContactTrackSpec(index=slot, rate=0.4, sigma=2e-7, window=6.0, step=4e-7),),
    )
    synth.publish_voices([voice])
    out = synth.render(256)  # opens the voice
    row = synth._voice_ids[42]
    assert synth.active_voices == 1 and bool(synth.voices.active[row])
    assert torch.isfinite(out).all() and out.abs().max() > 0
    synth.publish_voices([voice])
    synth.render(256)  # keeps it: the carries advance, nothing resets
    assert synth._voice_ids == {42: row} and int(synth.voices.age[row]) == 512
    assert bool(synth.voices.primed[row])
    synth.publish_voices([])
    before = coupled.LAUNCHES
    synth.render(256)  # ends it: the block is voice-free again
    assert synth.active_voices == 0 and not bool(synth.voices.active[row])
    assert coupled.LAUNCHES == before  # the CPU path launches no kernel
