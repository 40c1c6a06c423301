"""The render corpus goldens through the port: each of the JAX package's corpus scenes
(scripts/render_corpus.py), carried into the port with `convert.registry`, renders on the
CPU within one quantization step of its committed golden in tests/fixtures/render_corpus/
(the reference's committed-render diff oracle, README.md:184-197).

The goldens were written by the JAX package. A pixel may differ by more than one step only
where the port's rasterizer and XLA's fused program resolve a near-tie in depth to
different triangles: a contested pixel (`chip_smoke.contested_pixels`: the winning
triangle and another both cover the pixel center, their float64 depths within 1e-4).
Measured on the CPU: pbr_grid 7 such pixels, torus_wireframe 5,
primitives_line 3, supersampled 2, cuboid_flat_pointlight, spotlight_floor and
morph_blend 1, the other five 0; the largest is 7 of 38,400. No other pixel is more than
one step off."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from render_corpus import FIXTURE_DIR, SCENES  # noqa: E402  (imports the JAX package)

from mesheditor_tpu_torch import convert  # noqa: E402
from mesheditor_tpu_torch.render import RenderSettings, render_scene  # noqa: E402
from mesheditor_tpu_torch.render.camera import Camera  # noqa: E402
from mesheditor_tpu_torch.scene.derive import install_default_pipeline  # noqa: E402

CONTESTED_SHARE = chip_smoke.CONTESTED_SHARE  # of the image's pixels: 19 of 38,400


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pil_png(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def port_scene(name):
    """(port registry, port camera or None, port RenderSettings) of a reference corpus scene."""
    ref, cam, settings = SCENES[name]()
    reg = convert.registry({e: [ref.get(e, t) for t in ref.component_types() if ref.has(e, t)]
                            for e in ref.entities()})
    install_default_pipeline(reg)
    if cam is not None:
        cam = Camera(eye=cam.eye, target=cam.target, up=cam.up, fov_y=cam.fov_y,
                     near=cam.near, far=cam.far)
    return reg, cam, RenderSettings(**{f: getattr(settings, f)
                                       for f in RenderSettings.__dataclass_fields__})


@pytest.mark.parametrize("name", sorted(SCENES))
def test_golden(name):
    reg, cam, settings = port_scene(name)
    view = render_scene(reg, camera=cam, settings=settings, device="cpu")
    golden = _pil_png(os.path.join(FIXTURE_DIR, f"{name}.png"))
    n_bad, n_contested = chip_smoke.golden_check(view, golden)
    assert n_bad == n_contested, f"{name}: {n_bad - n_contested} uncontested pixels off"
    assert n_bad <= CONTESTED_SHARE * settings.width * settings.height, n_bad
    assert n_bad <= 7  # the largest count measured


def test_chip_smoke_builds_the_same_scenes():
    """The six scenes chip_smoke.py builds with the port's own components (the card's
    machine has no JAX) are the corpus scenes: the same flattened draw soup and rows."""
    from mesheditor_tpu_torch.render.scene_render import flatten_scene

    for name in chip_smoke.RENDER_GOLDENS:
        reg, cam, settings = port_scene(name)
        own, own_cam, own_settings = chip_smoke.corpus_scene(name)
        for r in (reg, own):
            r.process()
        a, b = flatten_scene(reg, device="cpu"), flatten_scene(own, device="cpu")
        for f in ("positions", "normals", "triangles", "tri_obj", "uvs"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=(name, f))
        for table in ("materials", "lights"):
            for f, x in getattr(a, table)._asdict().items():
                y = getattr(getattr(b, table), f)
                assert (x is None) == (y is None), (name, table, f)
                if x is not None:
                    assert torch.equal(x, y), (name, table, f)
        assert (a.atlas is None) == (b.atlas is None)
        if a.atlas is not None:
            assert all(torch.equal(x, y) for x, y in zip(a.atlas, b.atlas))
        assert (cam is None) == (own_cam is None)
        if cam is not None:
            np.testing.assert_array_equal(cam.eye, own_cam.eye)
        for f in ("width", "height", "mode", "supersample", "ambient", "background"):
            assert getattr(settings, f) == getattr(own_settings, f), (name, f)
        env_a, env_b = settings.environment, own_settings.environment
        assert (env_a is None) == (env_b is None)
        if env_a is not None:
            np.testing.assert_array_equal(env_a, env_b)


def test_read_png_decodes_as_pil_does(tmp_path):
    """The port's PNG reader (`render.record.read_png`, zlib only; chip_smoke.py decodes
    the goldens with it on the card) against PIL on every golden (PIL's adaptive filters)
    and on the port's own filter-0 files."""
    from mesheditor_tpu_torch.render.record import encode_png, read_png

    for name in SCENES:
        path = os.path.join(FIXTURE_DIR, f"{name}.png")
        np.testing.assert_array_equal(read_png(path), _pil_png(path))
    rgb = np.random.default_rng(5).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    (tmp_path / "probe.png").write_bytes(encode_png(rgb))
    np.testing.assert_array_equal(read_png(tmp_path / "probe.png"), rgb)
