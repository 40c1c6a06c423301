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
        " 'viz', 'parallel', 'parallel.sharding', 'parallel.launch', 'parallel.dryrun']\n"
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


@pytest.mark.parametrize("sub,not_ported_yet", [
    ("mesh", set()),
    ("physics", set()),
    ("render", set()),
    ("io", set()),
    ("scene", set()),
    ("app", set()),
    ("parallel", set()),
])
def test_public_names_match_the_reference_package(sub, not_ported_yet):
    """Each ported subpackage exports what the reference's `__init__` exports, less the
    names of modules that are still to be ported, and every name resolves."""
    import importlib

    port = importlib.import_module(f"mesheditor_tpu_torch.{sub}")
    ref = importlib.import_module(f"mesheditor_tpu.{sub}")
    assert set(port.__all__) == set(ref.__all__) - not_ported_yet
    assert not_ported_yet <= set(ref.__all__)
    for name in port.__all__:
        assert type(getattr(port, name)) is type(getattr(ref, name)), name


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
