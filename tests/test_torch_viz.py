"""The port's viz module (matplotlib figures to PNG files, no device) against the JAX
package's on the same inputs: every function writes a PNG whose decoded pixels equal the
reference function's, and without matplotlib the module still imports while each
function raises an ImportError that names it."""

import sys

import numpy as np
import pytest

import mesheditor_tpu.viz as ref_viz
import mesheditor_tpu_torch.viz as port_viz
from mesheditor_tpu_torch.mesh import icosphere_surface
from mesheditor_tpu_torch.render.record import read_png
from mesheditor_tpu_torch.types import ModalModes


def _modes():
    return ModalModes(freqs=np.linspace(100, 8000, 20), t60s=np.linspace(1, 0.05, 20),
                      shapes=np.zeros((1, 20, 3), np.float32))


def _cases():
    pts, tris = icosphere_surface(1)
    t = np.arange(24000) / 48000
    audio = np.exp(-t * 8) * np.sin(2 * np.pi * 700 * t)
    return {
        "render_mesh_png": ((pts, tris), {"vertex_values": pts[:, 1], "title": "sphere"}),
        "plot_modes_png": ((_modes(),), {}),
        "plot_waveform_png": ((audio,), {}),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_png_equals_the_references(tmp_path, name):
    args, kwargs = _cases()[name]
    getattr(port_viz, name)(tmp_path / "port.png", *args, **kwargs)
    getattr(ref_viz, name)(tmp_path / "ref.png", *args, **kwargs)
    assert (tmp_path / "port.png").stat().st_size > 5_000
    port, ref = read_png(tmp_path / "port.png"), read_png(tmp_path / "ref.png")
    assert port.std() > 1.0
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_without_matplotlib_each_function_names_itself(tmp_path, monkeypatch, name):
    for mod in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args, kwargs = _cases()[name]
    with pytest.raises(ImportError, match=f"viz.{name} needs matplotlib"):
        getattr(port_viz, name)(tmp_path / "x.png", *args, **kwargs)
    assert not (tmp_path / "x.png").exists()
