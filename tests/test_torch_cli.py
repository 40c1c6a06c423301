"""`python -m mesheditor_tpu_torch` on the CPU, in-process: a surface file goes in, a stored
modal model comes out, is inspected and rendered to a wav (solve|info|render); a mesh and a
glTF scene are screenshot and recorded (view|record); a glTF scene with an embedded model
is simulated to audio and video (simulate); a session is listed and restored to a project
(sessions); the interactive viewer is served on a free port and driven over HTTP (edit)."""

import re

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch.__main__ import main
from mesheditor_tpu_torch.io import load_modal_model, read_wav
from mesheditor_tpu_torch.mesh import cdt, icosphere_surface, save_obj, save_ply


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """`solve` on a 10 cm glass icosphere written as .obj; returns (store dir, model path,
    what the command printed)."""
    root = tmp_path_factory.mktemp("cli")
    pts, tris = icosphere_surface(1)
    save_obj(root / "ball.obj", pts * 0.1, tris)
    import contextlib
    import io

    out = io.StringIO()
    meshes = cdt.NATIVE_MESHES
    with contextlib.redirect_stdout(out):
        main(["solve", str(root / "ball.obj"), "--material", "Glass", "--modes", "6",
              "--vertices", "4", "--max-freq", "24000", "--tet-resolution", "6",
              "--out-dir", str(root / "modal"), "--device", "cpu"])
    assert cdt.NATIVE_MESHES == meshes + 1
    text = out.getvalue()
    model = re.search(r"model -> (\S+)", text).group(1)
    return root, model, text


def test_solve_stores_a_model(solved):
    root, model, text = solved
    assert "mesh: 42 verts, 80 tris; material Glass" in text
    assert re.search(r"solved 6 modes, f1 \d+\.\d Hz, mass \d+\.\d+ kg", text)
    assert re.search(r"\(\d+ iterations, \d+ dofs\)", text)
    assert [p.name for p in (root / "modal").iterdir()] == [model.rsplit("/", 1)[1]]
    modes, mass = load_modal_model(model)
    assert modes.num_modes == 6 and modes.shapes.shape == (4, 6, 3)
    assert 5 < mass.mass < 12  # a 10 cm glass ball
    assert 8e3 < modes.freqs[0] < 2e4


def test_info_prints_the_model(solved, capsys):
    _root, model, _text = solved
    main(["info", model])
    text = capsys.readouterr().out
    modes, mass = load_modal_model(model)
    assert "modes: 6  sample points: 4" in text
    assert f"mass: {mass.mass:.4f} kg" in text
    assert f"mode  0: {modes.freqs[0]:9.2f} Hz" in text
    assert len(re.findall(r"mode +\d+:", text)) == 6


def test_render_writes_a_wav(solved, capsys):
    root, model, _text = solved
    wav = root / "ball.wav"
    main(["render", model, "--out", str(wav), "--seconds", "0.25", "--strikes", "2",
          "--seed", "3", "--device", "cpu"])
    assert re.search(r"rendered 0.25s \(2 strikes\) -> \S+ball.wav \(peak \d",
                     capsys.readouterr().out)
    audio, rate = read_wav(wav)
    assert rate == 48000 and audio.shape == (1, 24 * 512)
    assert np.isfinite(audio).all() and np.abs(audio).max() == pytest.approx(0.9, abs=1e-3)


def test_solve_reads_ply_and_refuses_an_unknown_material(tmp_path, capsys):
    pts, tris = icosphere_surface(1)
    save_ply(tmp_path / "ball.ply", pts * 0.1, tris)
    with pytest.raises(SystemExit, match="unknown material 'Cheese'"):
        main(["solve", str(tmp_path / "ball.ply"), "--material", "Cheese", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no modes in the band"):
        main(["solve", str(tmp_path / "ball.ply"), "--material", "Glass", "--modes", "4",
              "--vertices", "2", "--tet-resolution", "6", "--out-dir", str(tmp_path / "m"),
              "--max-freq", "5000", "--device", "cpu"])  # the ball rings above 10 kHz
    assert "mesh: 42 verts, 80 tris" in capsys.readouterr().out


def test_cuda_is_the_default_device_and_raises_without_a_card(solved):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    _root, model, _text = solved
    with pytest.raises(RuntimeError, match="cuda"):
        main(["render", model, "--seconds", "0.1"])


def _png_pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_view_writes_a_png(tmp_path, capsys):
    pts, tris = icosphere_surface(2)
    save_obj(tmp_path / "ball.obj", pts, tris)
    out = tmp_path / "shot.png"
    main(["view", str(tmp_path / "ball.obj"), "--out", str(out), "--width", "48",
          "--height", "36", "--mode", "flat", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "mesh: 162 verts, 320 tris" in text and "(48x36, flat)" in text
    img = _png_pixels(out)
    assert img.shape == (36, 48, 3) and img.std() > 1.0


def test_record_writes_png_frames(tmp_path, capsys):
    pts, tris = icosphere_surface(1)
    save_ply(tmp_path / "ball.ply", pts, tris)
    main(["record", str(tmp_path / "ball.ply"), "--out", str(tmp_path / "spin.png"),
          "--frames", "3", "--width", "32", "--height", "24", "--device", "cpu"])
    assert "(3 frames @ 12.0 fps)" in capsys.readouterr().out
    frames = sorted(tmp_path.glob("spin_*.png"))
    assert len(frames) == 3
    first, last = _png_pixels(frames[0]), _png_pixels(frames[-1])
    assert first.shape == (24, 32, 3) and not np.array_equal(first, last)


@pytest.mark.parametrize("command", ["view", "record"])
def test_gltf_is_refused_until_its_import_is_ported(tmp_path, command):
    """glTF import is ported: `view` and `record` hand a .glb to the importer, and a
    truncated file fails there (the GLB header cannot be read), not at a refusal."""
    import struct

    import mesheditor_tpu_torch.__main__ as cli

    scene = tmp_path / "scene.glb"
    scene.write_bytes(b"glTF")
    with pytest.raises(struct.error):
        main([command, str(scene), "--device", "cpu"])
    assert "not ported yet" not in open(cli.__file__).read()


@pytest.fixture(scope="module")
def drop_scene(tmp_path_factory):
    """A .glb of a floor and a 10 cm ball dropped onto it from 8 cm, its modal model (a
    synthetic 6-mode model) embedded: the file plays with no solve."""
    from mesheditor_tpu_torch.io.gltf import export_gltf
    from mesheditor_tpu_torch.io.model_store import save_modal_model
    from mesheditor_tpu_torch.scene import components as c
    from mesheditor_tpu_torch.scene.registry import Registry
    from mesheditor_tpu_torch.types import MassProperties, ModalModes

    root = tmp_path_factory.mktemp("drop")
    rng = np.random.default_rng(7)
    modes = ModalModes(freqs=np.linspace(900.0, 4000.0, 6), t60s=np.linspace(0.6, 0.2, 6),
                       shapes=rng.normal(0.0, 0.02, (4, 6, 3)).astype(np.float32),
                       positions=rng.normal(0.0, 0.04, (4, 3)))
    model = save_modal_model(root / "store", modes, MassProperties(mass=0.5))
    r = Registry()
    floor = r.create()
    r.emplace(floor, c.Name("floor"))
    r.emplace(floor, c.RigidBodyComponent(shape_kind="plane"))
    ball = r.create()
    pts, tris = icosphere_surface(2)
    r.emplace(ball, c.Name("ball"))
    r.emplace(ball, c.MeshSurface(positions=pts * 0.05, triangles=tris))
    r.emplace(ball, c.Transform(translation=np.array([0.0, 0.13, 0.0])))
    r.emplace(ball, c.RigidBodyComponent(shape_kind="sphere", radius=0.05, is_dynamic=True,
                                         mass=0.5, linear_velocity=np.array([0.3, 0.0, 0.0])))
    r.emplace(ball, c.AcousticMaterialRef())
    r.emplace(ball, c.SolveSettingsComponent())
    r.emplace(ball, c.ModalModel(path=str(model)))
    export_gltf(r, root / "drop.glb")
    return root / "drop.glb"


def test_simulate_plays_the_embedded_model_and_records_frames(drop_scene, tmp_path, capsys):
    main(["simulate", str(drop_scene), "--seconds", "0.2", "--out", str(tmp_path / "s.wav"),
          "--store", str(tmp_path / "store"), "--video", str(tmp_path / "f.png"),
          "--video-fps", "20", "--video-width", "32", "--video-height", "24",
          "--device", "cpu"])
    text = capsys.readouterr().out
    assert "scene: 2 entities" in text and "solve progress" not in text  # nothing solved
    assert re.search(r"simulated 0.2s of physics audio -> \S+s.wav \(peak \d", text)
    audio, rate = read_wav(tmp_path / "s.wav")
    assert rate == 48000 and audio.shape == (1, 19 * 512)
    assert np.isfinite(audio).all() and np.abs(audio).max() == pytest.approx(0.9, abs=1e-3)
    frames = sorted(tmp_path.glob("f_*.png"))
    assert 3 <= len(frames) <= 5 and f"video: {len(frames)} frames" in text
    assert _png_pixels(frames[0]).shape == (24, 32, 3)


def test_view_gltf_overlays_the_colliders(drop_scene, tmp_path, capsys):
    out = tmp_path / "v.png"
    main(["view", str(drop_scene), "--out", str(out), "--width", "48", "--height", "36",
          "--supersample", "1", "--debug-physics", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "scene: 1 mesh entities, 320 triangles" in text
    assert "debug overlay: 2 collider wireframes" in text and "(48x36, smooth)" in text
    assert _png_pixels(out).std() > 1.0


def test_record_gltf_frames_the_world_space_scene(drop_scene, tmp_path, capsys):
    """The camera frames the scene's world-space points: the ball, 13 cm up, is in every
    frame, and the frames turn."""
    main(["record", str(drop_scene), "--out", str(tmp_path / "spin.png"), "--frames", "2",
          "--width", "32", "--height", "24", "--device", "cpu"])
    assert "(2 frames @ 12.0 fps)" in capsys.readouterr().out
    first, last = (_png_pixels(p) for p in sorted(tmp_path.glob("spin_*.png")))
    background = np.round(np.asarray([0.125, 0.133, 0.153]) * 255)
    assert (np.abs(first - background).max(-1) > 2).mean() > 0.05  # the ball covers pixels
    assert not np.array_equal(first, last)


def test_sessions_list_and_restore_to_a_project(tmp_path, capsys):
    from mesheditor_tpu_torch.io.project import load_project
    from mesheditor_tpu_torch.scene import actions as A
    from mesheditor_tpu_torch.scene.session import Session
    from mesheditor_tpu_torch.scene.snapshot import snapshot_scene

    root = tmp_path / "sessions"
    main(["sessions", "list", "--root", str(root)])
    assert capsys.readouterr().out.strip() == "no sessions"
    s = Session(root=root)
    for a in (A.AddObject(name="bowl"), A.AddPrimitive(name="ring", kind="torus", size=0.1),
              A.SetAcousticMaterial(entity=1, name="Iron"), A.SetGain(entity=2, value=0.25)):
        s.apply(a)
        s.process()
    s.close()
    main(["sessions", "list", "--root", str(root)])
    assert capsys.readouterr().out.strip() == f"{s.dir.name}: 4 actions"
    main(["sessions", "restore", "--root", str(root), "--out", str(tmp_path / "s.project")])
    text = capsys.readouterr().out
    assert f"restored {s.dir.name}: 2 named objects: ['bowl', 'ring']" in text
    assert "replay self-test: byte-exact" in text
    assert snapshot_scene(load_project(tmp_path / "s.project")) == snapshot_scene(s.registry)


def test_simulate_defaults_to_the_card(drop_scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["simulate", str(drop_scene), "--seconds", "0.05", "--out",
              str(tmp_path / "s.wav"), "--store", str(tmp_path / "store")])


def test_view_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    pts, tris = icosphere_surface(1)
    save_obj(tmp_path / "ball.obj", pts, tris)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["view", str(tmp_path / "ball.obj"), "--out", str(tmp_path / "x.png")])


def test_edit_defaults_to_the_card_and_raises_before_binding_a_port(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    import mesheditor_tpu_torch.app as app_pkg

    bound = []
    monkeypatch.setattr(app_pkg, "serve", lambda *a, **k: bound.append(a))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("MESHEDITOR_TPU_SESSION_DIR", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["edit", "--port", "0"])
    assert not bound and not (tmp_path / ".mesheditor_tpu").exists()


def test_edit_opens_a_project(tmp_path, monkeypatch):
    """A .project loads through io.project and is what the served app edits."""
    import mesheditor_tpu_torch.app as app_pkg
    from mesheditor_tpu_torch.io.project import save_project
    from mesheditor_tpu_torch.scene import actions as A
    from mesheditor_tpu_torch.scene.session import Session
    from mesheditor_tpu_torch.scene.snapshot import snapshot_scene

    s = Session(root=tmp_path / "sessions")
    for a in (A.AddPrimitive(name="ring", kind="torus", size=0.1),
              A.SetAcousticMaterial(entity=1, name="Glass")):
        s.apply(a)
        s.process()
    s.close()
    save_project(tmp_path / "ring.project", s.registry)
    served = []
    monkeypatch.setattr(app_pkg, "serve", lambda app, port: served.append((app, port)))
    monkeypatch.setenv("MESHEDITOR_TPU_SESSION_DIR", str(tmp_path / "edit_sessions"))
    main(["edit", str(tmp_path / "ring.project"), "--port", "0", "--width", "96", "--height",
          "60", "--device", "cpu"])
    (app, port), = served
    assert port == 0 and (app.width, app.height, app.device.type) == (96, 60, "cpu")
    assert snapshot_scene(app.registry) == snapshot_scene(s.registry)
    assert [o["name"] for o in app.state()["objects"]] == ["ring"]


def test_edit_serves_a_gltf_scene_over_http(drop_scene, tmp_path):
    """`edit scene.glb --port 0` as a fresh process: it prints the port it bound, serves
    the state, a click, a frame, a bad inspect query (400) and a byte-exact replay, and
    records its session under HOME."""
    import json
    import os
    import subprocess
    import sys
    import time
    import urllib.error
    import urllib.request
    from pathlib import Path

    from mesheditor_tpu_torch.render.record import decode_png

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, HOME=str(tmp_path), PYTHONPATH=str(repo))
    env.pop("MESHEDITOR_TPU_SESSION_DIR", None)
    out = open(tmp_path / "out.txt", "w")
    proc = subprocess.Popen([sys.executable, "-m", "mesheditor_tpu_torch", "edit",
                             str(drop_scene), "--port", "0", "--width", "96", "--height", "60",
                             "--device", "cpu"], stdout=out, stderr=subprocess.STDOUT, env=env)
    try:
        deadline = time.monotonic() + 120
        while not re.search(r"viewer on http://127.0.0.1:(\d+)/",
                            (tmp_path / "out.txt").read_text()):
            assert proc.poll() is None, (tmp_path / "out.txt").read_text()
            assert time.monotonic() < deadline, "edit printed no address"
            time.sleep(0.2)
        port = re.search(r"viewer on http://127.0.0.1:(\d+)/",
                         (tmp_path / "out.txt").read_text()).group(1)
        base = f"http://127.0.0.1:{port}"

        def call(path, body=None):
            data = None if body is None else json.dumps(body).encode()
            try:
                with urllib.request.urlopen(urllib.request.Request(base + path, data=data),
                                            timeout=60) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        code, body = call("/state")
        assert code == 200 and [o["name"] for o in json.loads(body)["objects"]] == ["floor", "ball"]
        session_dir = Path(json.loads(body)["session_dir"])
        assert session_dir.parent == tmp_path / ".mesheditor_tpu" / "sessions"
        code, body = call("/event", {"type": "click", "x": 48, "y": 30})
        assert code == 200 and json.loads(body)["selected_name"] == "ball"
        code, body = call("/frame")
        assert code == 200 and decode_png(body).shape == (60, 96, 4)
        assert call("/inspect?entity=abc")[0] == 400
        code, body = call("/inspect?entity=2")
        assert code == 200 and "RigidBodyComponent" in json.loads(body)["components"]
        code, body = call("/verify-replay", {})
        assert code == 200 and json.loads(body)["byte_exact"]
        assert proc.poll() is None
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        out.close()
    assert "Traceback" not in (tmp_path / "out.txt").read_text()


def test_warmup_parses_its_sets_and_needs_a_card_for_cuda(monkeypatch):
    """`warmup --set quickstart|bench|all --device`: the parser takes the three sets and
    refuses others; on the default device (the card) it raises without one, before it
    builds anything."""
    import mesheditor_tpu_torch.__main__ as cli

    seen = []
    monkeypatch.setattr(cli, "cmd_warmup", lambda args: seen.append((args.set, args.device)))
    for argv in (["warmup"], ["warmup", "--set", "bench", "--device", "cpu"],
                 ["warmup", "--set", "all"]):
        cli.main(argv)
    assert seen == [("quickstart", "cuda"), ("bench", "cpu"), ("all", "cuda")]
    with pytest.raises(SystemExit):
        cli.main(["warmup", "--set", "nope"])
    monkeypatch.undo()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["warmup", "--device", "cuda"])
