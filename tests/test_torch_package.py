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
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import mesheditor_tpu_torch, mesheditor_tpu_torch.api, mesheditor_tpu_torch.convert\n"
        "import mesheditor_tpu_torch.solve, mesheditor_tpu_torch.synth, mesheditor_tpu_torch.fem\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and (m == 'mesheditor_tpu'"
        " or m.startswith(('mesheditor_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_jax_or_reference():
    for path in PKG.rglob("*.py"):
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


def test_sustained_voices_are_refused():
    modes = ModalModes(np.array([440.0]), np.array([0.5]), np.zeros((1, 1, 3), np.float32))
    synth = make_synth([modes], device="cpu")
    with pytest.raises(NotImplementedError):
        synth.publish_voices([])
