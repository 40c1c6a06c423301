"""The render layer's host modules against the JAX package's: camera math, selection
state, the transform gizmo and the physics debug draw are exact copies (their projection
is the port's exact float32 multiply-add, bit-equal to the JAX package's), and the
standard-library PNG writer decodes to the pixels the reference's PIL writer stores.
Recording: PNG frames, GIF through PIL (a clear ImportError without it), the .mp4 -> .gif
rule, and turntable / animation frames against the reference's."""

import shutil
import sys

import numpy as np
import pytest
import torch

import mesheditor_tpu  # noqa: F401  (enables x64)
from mesheditor_tpu.mesh import cuboid_surface, icosphere_surface
from mesheditor_tpu.physics import scene_build as ref_scene_build
from mesheditor_tpu.render import camera as rcam
from mesheditor_tpu.render import debug_draw as rdebug
from mesheditor_tpu.render import gizmo as rgizmo
from mesheditor_tpu.render import record as rrecord
from mesheditor_tpu.render import scene_render as rscene
from mesheditor_tpu.render.selection_state import SelectionState as RefSelection
from mesheditor_tpu.scene import animation as ranim
from mesheditor_tpu.scene import components as rc
from mesheditor_tpu.scene.derive import install_default_pipeline as ref_pipeline
from mesheditor_tpu.scene.registry import Registry as RefRegistry

from mesheditor_tpu_torch.physics import scene_build
from mesheditor_tpu_torch.render import camera as pcam
from mesheditor_tpu_torch.render import debug_draw as pdebug
from mesheditor_tpu_torch.render import gizmo as pgizmo
from mesheditor_tpu_torch.render import record as precord
from mesheditor_tpu_torch.render import scene_render as pscene
from mesheditor_tpu_torch.render.selection_state import SelectionState
from mesheditor_tpu_torch.scene import animation as panim
from mesheditor_tpu_torch.scene import components as pc
from mesheditor_tpu_torch.scene.derive import install_default_pipeline
from mesheditor_tpu_torch.scene.registry import Registry


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same_camera(a, b):
    for f in ("eye", "target", "up", "fov_y", "near", "far"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _pil_decode(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def test_camera_bit_for_bit():
    rng = np.random.default_rng(20261016)
    for _ in range(5):
        eye, target = rng.normal(size=3), rng.normal(size=3)
        np.testing.assert_array_equal(pcam.look_at(eye, target), rcam.look_at(eye, target))
    # Looking straight along up takes the fallback right vector.
    np.testing.assert_array_equal(pcam.look_at((0, 3, 0), (0, 0, 0)),
                                  rcam.look_at((0, 3, 0), (0, 0, 0)))
    np.testing.assert_array_equal(pcam.perspective(0.8, 1.5, 0.05, 40.0),
                                  rcam.perspective(0.8, 1.5, 0.05, 40.0))
    a, b = pcam.Camera(), rcam.Camera()
    _same_camera(a, b)
    np.testing.assert_array_equal(a.view(), b.view())
    np.testing.assert_array_equal(a.projection(1.25), b.projection(1.25))
    np.testing.assert_array_equal(pcam.view_projection(a, 97, 61),
                                  rcam.view_projection(b, 97, 61))
    _same_camera(pcam.orbit_camera((1, 2, 3), 4.5, 30.0, -10.0),
                 rcam.orbit_camera((1, 2, 3), 4.5, 30.0, -10.0))
    pts = rng.normal(size=(50, 3))
    _same_camera(pcam.frame_points(pts, margin=1.2, azimuth_deg=15.0),
                 rcam.frame_points(pts, margin=1.2, azimuth_deg=15.0))
    _same_camera(pcam.frame_points(np.zeros((0, 3))), rcam.frame_points(np.zeros((0, 3))))


def test_selection_state_follows_reference():
    _pts, tris = icosphere_surface(1)
    a, b = SelectionState(42, tris), RefSelection(42, tris)

    def same():
        for f in ("vertices", "edges", "faces", "edge_list", "triangles"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert a.counts() == b.counts()

    same()
    for domain, ids, mode in (("vertices", [0, 5, 7], "replace"), ("vertices", [9], "add"),
                              ("vertices", [5], "subtract"), ("faces", [1, 2, 3], "toggle"),
                              ("edges", np.array([4, 8]), "add")):
        a.apply(domain, ids, mode)
        b.apply(domain, ids, mode)
        same()
    with pytest.raises(ValueError, match="unknown mode"):
        a.apply("faces", [1], "merge")
    for v0, v1 in ((0, 1), (5, 2), (0, 41)):
        assert a.edge_id(v0, v1) == b.edge_id(v0, v1)
    for op, arg in (("grow_vertices", 2), ("shrink_vertices", 1), ("invert", "faces")):
        getattr(a, op)(arg)
        getattr(b, op)(arg)
        same()
    for conv in ("faces_to_vertices", "vertices_to_faces", "vertices_to_edges"):
        np.testing.assert_array_equal(getattr(a, conv)(), getattr(b, conv)())
    a.clear()
    b.clear()
    same()


def test_gizmo_follows_reference():
    cam_p = pcam.Camera(eye=np.array([2.0, 1.5, 3.0]))
    cam_r = rcam.Camera(eye=np.array([2.0, 1.5, 3.0]))
    center = np.array([0.1, 0.2, -0.1])
    for px in ((80.0, 60.0), (100.5, 42.0), (10.0, 110.0)):
        for a, b in zip(pgizmo.ray_through_pixel(cam_p, 160, 120, *px),
                        rgizmo.ray_through_pixel(cam_r, 160, 120, *px)):
            np.testing.assert_array_equal(a, b)
    geo, rgeo = pgizmo.handle_points(center, 0.7), rgizmo.handle_points(center, 0.7)
    assert geo["radius"] == rgeo["radius"]
    for key in ("tips", "pads"):
        for i in range(3):
            np.testing.assert_array_equal(geo[key][i], rgeo[key][i])
    # Hit-test the projected axis tips, pads and rotation rings, and the empty space.
    mvp = pcam.view_projection(cam_p, 160, 120)
    from mesheditor_tpu_torch.render.raster import project_points, screen_coords

    def px_of(p):
        return screen_coords(project_points(mvp, np.reshape(p, (1, 3)), device="cpu").numpy(),
                             160, 120)[0]

    probes = [px_of(center + (geo["tips"][i] - center) * 0.6) for i in range(3)]
    probes += [px_of(geo["pads"][i]) for i in range(3)] + [np.array([2.0, 2.0])]
    hits = 0
    for mode in ("translate", "rotate", "scale"):
        for p in probes:
            h = pgizmo.pick_handle(cam_p, 160, 120, p[0], p[1], center, mode, size=0.7)
            rh = rgizmo.pick_handle(cam_r, 160, 120, p[0], p[1], center, mode, size=0.7)
            assert (h is None) == (rh is None)
            if h is not None:
                hits += 1
                assert (h.mode, h.axis, h.plane) == (rh.mode, rh.axis, rh.plane)
    assert hits >= 6
    # Drags: axis and plane translate, rotate, scale.
    start = pgizmo.ray_through_pixel(cam_p, 160, 120, 80.0, 60.0)
    move = pgizmo.ray_through_pixel(cam_p, 160, 120, 95.0, 52.0)
    for mode, axis, plane in (("translate", 0, False), ("translate", 1, True),
                              ("rotate", 2, False), ("scale", 0, False)):
        t = pc.Transform(translation=center.copy())
        rt = rc.Transform(translation=center.copy())
        got = pgizmo.GizmoDrag(pgizmo.Handle(mode, axis, plane), t, start).update(move)
        ref = rgizmo.GizmoDrag(rgizmo.Handle(mode, axis, plane), rt, start).update(move)
        assert isinstance(got, pc.Transform)
        for f in ("translation", "rotation", "scale"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=(mode, f))
    axes, raxes = pgizmo.orientation_axes(cam_p), rgizmo.orientation_axes(cam_r)
    assert axes.keys() == raxes.keys()
    for k in axes:
        np.testing.assert_array_equal(axes[k], raxes[k])
    for axis in ("+x", "-y", "+z", "+y"):
        _same_camera(pgizmo.snap_view(cam_p, axis), rgizmo.snap_view(cam_r, axis))


def _collider_scene(mod, registry):
    """A plane, a sphere, a box, a capsule and a mesh body; a ball falls onto the plane."""
    reg = registry()
    floor = reg.create()
    reg.emplace(floor, mod.RigidBodyComponent(shape_kind="plane"))
    pts, tris = cuboid_surface((0.05, 0.04, 0.03))
    for i, kind in enumerate(("sphere", "box", "capsule", "mesh")):
        e = reg.create()
        reg.emplace(e, mod.Transform(translation=np.array([0.3 * i - 0.45, 0.06, 0.1 * i])))
        if kind == "mesh":
            reg.emplace(e, mod.MeshSurface(positions=pts, triangles=tris))
        reg.emplace(e, mod.RigidBodyComponent(
            shape_kind=kind, radius=0.04, half_height=0.05,
            half_extents=np.array([0.05, 0.03, 0.04]), is_dynamic=True, mass=0.3,
            angular_velocity=np.array([0.5, 1.0, -0.3])))
    return reg


def test_debug_draw_follows_reference():
    world, _ = scene_build.build_world(_collider_scene(pc, Registry))
    rworld, _ = ref_scene_build.build_world(_collider_scene(rc, RefRegistry))
    for _ in range(40):  # the bodies settle into sustained contacts
        world.step()
        rworld.step()
    assert world.sustained
    segs, rsegs = pdebug.world_segments(world), rdebug.world_segments(rworld)
    assert [h for h, _ in segs] == [h for h, _ in rsegs] and len(segs) == 5
    for (_, a), (_, b) in zip(segs, rsegs):
        np.testing.assert_array_equal(a, b)
    cam_p = pcam.Camera(eye=np.array([0.3, 0.8, 1.6]), target=np.zeros(3), near=0.05)
    cam_r = rcam.Camera(eye=np.array([0.3, 0.8, 1.6]), target=np.zeros(3), near=0.05)
    base = np.random.default_rng(2).random((90, 120, 3))
    got = pdebug.draw_physics_debug(base, world, cam_p)
    ref = rdebug.draw_physics_debug(base, rworld, cam_r)
    np.testing.assert_array_equal(got, ref)
    assert (got != base).any(axis=-1).sum() > 200
    np.testing.assert_array_equal(pdebug.draw_segments(base, segs[1][1], cam_p, (1, 0, 0)),
                                  rdebug.draw_segments(base, rsegs[1][1], cam_r, (1, 0, 0)))


def test_png_writer_decodes_as_reference(tmp_path):
    rng = np.random.default_rng(20261016)
    img = rng.random((37, 53, 3))
    img[0, 0] = (-0.2, 1.3, 0.5 / 255)  # clipped and rounded like the reference
    pscene.save_png(tmp_path / "port.png", img)
    rscene.save_png(tmp_path / "ref.png", img)
    got, ref = _pil_decode(tmp_path / "port.png"), _pil_decode(tmp_path / "ref.png")
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, precord.to_u8(img))
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        precord.encode_png(np.zeros((4, 4), np.uint8))


def test_write_frames_and_record_png(tmp_path):
    frames = [np.random.default_rng(i).random((12, 20, 3)) for i in range(3)]
    paths = precord.write_frames(tmp_path / "frame.png", frames)
    assert [p.name for p in paths] == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    for p, f in zip(paths, frames):
        np.testing.assert_array_equal(_pil_decode(p), precord.to_u8(f))
    out = precord.record(tmp_path / "clip.png", iter(frames))
    assert out == tmp_path / "clip.png" and (tmp_path / "clip_0002.png").exists()
    with pytest.raises(ValueError, match="no frames"):
        precord.record(tmp_path / "none.png", [])


def test_gif_and_the_mp4_rule(tmp_path, monkeypatch):
    frames = [np.random.default_rng(i).random((12, 20, 3)) for i in range(4)]
    precord.write_gif(tmp_path / "port.gif", frames, fps=10)
    rrecord.write_gif(tmp_path / "ref.gif", frames, fps=10)
    assert (tmp_path / "port.gif").read_bytes() == (tmp_path / "ref.gif").read_bytes()
    monkeypatch.setattr(shutil, "which", lambda name: None)  # no ffmpeg
    assert precord.write_mp4(tmp_path / "x.mp4", frames) is False
    out = precord.record(tmp_path / "clip.mp4", frames, fps=10)
    assert out == tmp_path / "clip.gif" and out.exists()
    monkeypatch.setitem(sys.modules, "PIL", None)  # no PIL
    with pytest.raises(ImportError, match="PIL"):
        precord.write_gif(tmp_path / "none.gif", frames)
    with pytest.raises(ImportError, match="PIL"):
        precord.record(tmp_path / "none.gif", frames)
    precord.record(tmp_path / "still.png", frames)  # PNG frames need no PIL


def test_turntable_frames_follow_reference():
    pts, tris = icosphere_surface(2)
    vals = np.asarray(pts)[:, 0]
    got = list(precord.turntable_frames(pts, tris, n_frames=3, settings=pscene.RenderSettings(
        40, 30), vertex_values=vals, device="cpu"))
    ref = list(rrecord.turntable_frames(pts, tris, n_frames=3, settings=rscene.RenderSettings(
        40, 30), vertex_values=vals))
    assert len(got) == 3 and not np.array_equal(got[0], got[1])
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (30, 40, 3) and a.dtype == b.dtype
        diff = np.abs(a - b).max(-1)
        assert np.median(diff) < 1e-6 and (diff > 1e-4).sum() <= 2


def _morph_scene(mod, registry, pipeline):
    r = registry()
    pipeline(r)
    pts, tris = icosphere_surface(2)
    e = r.create()
    surf = mod.MeshSurface(positions=np.asarray(pts), triangles=np.asarray(tris, np.uint32))
    surf.morph_targets = (np.asarray(pts) * np.array([0.6, 0.0, -0.3]))[None]
    surf.morph_weights = np.zeros(1)
    r.emplace(e, surf)
    r.emplace(e, mod.Transform())
    return r, e


def test_animation_frames_follow_reference():
    r, e = _morph_scene(rc, RefRegistry, ref_pipeline)
    p, _ = _morph_scene(pc, Registry, install_default_pipeline)
    channel = dict(entity=e, times=np.array([0.0, 1.0]), values=np.array([[0.0], [1.0]]))
    rclip = ranim.AnimationClip("bulge", [ranim.AnimationChannel(
        path=ranim.TargetPath.WEIGHTS, interpolation=ranim.Interpolation.LINEAR, **channel)])
    pclip = panim.AnimationClip("bulge", [panim.AnimationChannel(
        path=panim.TargetPath.WEIGHTS, interpolation=panim.Interpolation.LINEAR, **channel)])
    cam = dict(eye=np.array([0.0, 0.5, 3.0]), near=0.1, far=20.0)
    kw = dict(fps=2, seconds=1.0, motion_blur_steps=2)
    got = list(precord.animation_frames(p, pclip, camera=pcam.Camera(**cam),
                                        settings=pscene.RenderSettings(32, 24), device="cpu",
                                        **kw))
    ref = list(rrecord.animation_frames(r, rclip, camera=rcam.Camera(**cam),
                                        settings=rscene.RenderSettings(32, 24), **kw))
    assert len(got) == len(ref) == 2 and not np.array_equal(got[0], got[1])
    for a, b in zip(got, ref):
        diff = np.abs(a - b).max(-1)
        assert np.median(diff) < 1e-6 and (diff > 1e-4).sum() <= 2
