"""The interactive viewer/editor of the port (app/viewer.py) on the CPU: the cases of
tests/test_viewer.py on the port, then one seeded event script driven through both
packages' ViewerApps (the reference on JAX's CPU backend) with equal state, inspector and
physics payloads, byte-equal action logs, sessions that replay byte-exact in the other
package, equal picks and frames within one step apart from contested pixels (near-ties in
depth, `chip_smoke.contested_pixels`); the waveform panel and a strike's audio from one
solved model through each package's synth; and what the port does differently: the
selection tint draws (the reference's never does), framing an empty scene puts nothing on a
device, `_ensure_synth` catches only the mesher's ValueError, and /inspect answers a bad
query with 400."""

import json
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from mesheditor_tpu.app.viewer import ViewerApp as RefViewerApp  # noqa: E402

from mesheditor_tpu_torch import convert  # noqa: E402
from mesheditor_tpu_torch.app import ViewerApp, serve  # noqa: E402
from mesheditor_tpu_torch.app import viewer as port_viewer  # noqa: E402
from mesheditor_tpu_torch.render.record import decode_png as _decode_png  # noqa: E402
from mesheditor_tpu_torch.scene.components import Transform  # noqa: E402
from mesheditor_tpu_torch.scene.session import verify_replay  # noqa: E402

W, H = 320, 200


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) pixels of an opaque PNG."""
    rgba = _decode_png(data)
    assert (rgba[..., 3] == 255).all()
    return rgba[..., :3]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_app(tmp_path, **kw):
    return ViewerApp(width=W, height=H, session_root=tmp_path / "sess", device="cpu", **kw)


def make_ref(tmp_path, **kw):
    return RefViewerApp(width=W, height=H, session_root=tmp_path / "ref_sess", **kw)


# ---- tests/test_viewer.py on the port ----

def test_add_select_render(tmp_path):
    app = make_app(tmp_path)
    st = app.handle({"type": "add", "kind": "cuboid"})
    assert [o["name"] for o in st["objects"]] == ["cuboid"]
    png = app.frame_png()
    assert png.startswith(b"\x89PNG") and len(png) > 1000
    st = app.handle({"type": "click", "x": 160, "y": 100})  # the cuboid fills the view
    assert st["selected"] >= 0 and st["selected_name"] == "cuboid"


def test_orbit_changes_frame(tmp_path):
    app = make_app(tmp_path)
    app.handle({"type": "add", "kind": "torus"})
    f1 = app.frame_png()
    app.handle({"type": "orbit", "dx": 60, "dy": 15})
    assert app.frame_png() != f1


def gizmo_hit(app):
    """A pixel that grabs an axis handle of the selected entity's translate gizmo."""
    from mesheditor_tpu_torch.render.gizmo import pick_handle

    cam, center = app.camera(), app._gizmo_center()
    for x in range(0, app.width, 4):
        for y in range(0, app.height, 4):
            h = pick_handle(cam, app.width, app.height, x, y, center, mode="translate",
                            size=app.radius * 0.18)
            if h is not None and not h.plane:
                return x, y
    return None


def test_gizmo_translate_emits_actions(tmp_path):
    app = make_app(tmp_path)
    app.handle({"type": "add", "kind": "cuboid"})
    app.handle({"type": "click", "x": 160, "y": 100})
    ent = app.selected
    app.handle({"type": "mode", "mode": "translate"})
    t0 = np.asarray(app.registry.get(ent, Transform).translation).copy()
    hit = gizmo_hit(app)
    assert hit is not None, "no gizmo handle hit-testable on screen"
    app.handle({"type": "drag_start", "x": hit[0], "y": hit[1]})
    assert app.drag is not None
    app.handle({"type": "drag_move", "x": hit[0] + 25, "y": hit[1]})
    app.handle({"type": "drag_end"})
    t1 = np.asarray(app.registry.get(ent, Transform).translation)
    assert not np.allclose(t0, t1), "drag must move the object"
    app.session.log.drain()
    assert "SetTransform" in (app.session.dir / "actions.log").read_text()


def test_delete_and_replay_exact(tmp_path):
    app = make_app(tmp_path)
    app.handle({"type": "add", "kind": "icosphere"})
    app.handle({"type": "add", "kind": "cone"})
    app.handle({"type": "click_entity", "entity": app.state()["objects"][0]["entity"]})
    app.handle({"type": "delete"})
    assert len(app.state()["objects"]) == 1
    v = app.verify()
    assert v["byte_exact"], f"viewer session must replay byte-exact: {v}"


def test_strike_records_action(tmp_path):
    app = make_app(tmp_path)
    app.handle({"type": "add", "kind": "cuboid"})
    app.handle({"type": "mode", "mode": "strike"})
    st = app.handle({"type": "click", "x": 160, "y": 100})
    assert st["struck"] and not st["has_audio"]  # audio off: nothing solved
    app.session.log.drain()
    assert "StrikeVertex" in (app.session.dir / "actions.log").read_text()
    assert app.verify()["byte_exact"]


def test_frame_png_is_an_rgb_png_of_the_quantised_image(tmp_path):
    """The one PNG codec (render/record.py:encode_png): colour type 2, the pixels of
    clip(img * 255) cast to uint8, as the reference's own encoder writes them."""
    app = make_app(tmp_path)
    app.handle({"type": "add", "kind": "cuboid"})
    png = app.frame_png()
    assert png.startswith(b"\x89PNG") and b"IEND" in png
    assert png[25] == 2  # IHDR colour type: RGB
    img = app._renderer_cache.image()
    want = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(decode_png(png), want)


def test_state_carries_audio_counters(tmp_path):
    a = make_app(tmp_path).state()["audio"]
    assert a["active_voices"] == 0 and a["active_impacts"] == 0
    assert a["events_dropped"] == 0 and a["solves"] == []
    assert not a["enabled"]


def test_waveform_unavailable_before_strike(tmp_path):
    assert make_app(tmp_path).waveform() == {"available": False}


def synthetic_strike(P, device=None):
    """tests/test_viewer.py's solve-free bank in package P (the reference or the port):
    two objects of four modes, one impact on object 0, 0.25 s rendered. Returns (synth,
    audio as float64 numpy)."""
    import importlib

    engine = importlib.import_module(f"{P}.synth.engine")
    types = importlib.import_module(f"{P}.types")
    rng = np.random.default_rng(0)
    k = 4
    modes = types.ModalModes(freqs=np.array([200.0, 450.0, 800.0, 1200.0]),
                             t60s=np.full(k, 0.3),
                             shapes=rng.standard_normal((3, k, 3)) * 0.01)
    kw = {"device": device} if device else {}
    synth = engine.ModalSynth([modes, modes], max_impacts=8, max_voices=2, **kw)
    synth.enqueue(engine.ModalEvent(kind="impact", obj=0, expos=0, j=(0.1, 0.1, 0.0),
                                    pulse_step=1 / 100.0, pulse_gamma=np.pi / 200.0,
                                    accel_amp=0.0))
    return synth, np.asarray(synth.render_seconds(0.25), np.float64)


def test_waveform_and_counters_after_synth(tmp_path):
    app = make_app(tmp_path)
    app._synth, app._last_audio = synthetic_strike("mesheditor_tpu_torch", "cpu")
    st = app.state()["audio"]
    assert st["bank_objects"] == 2 and st["bank_modes"] >= 4  # the bank pads the mode axis
    w = app.waveform()
    assert w["available"]
    assert len(w["env_hi"]) == len(w["env_lo"]) > 16
    assert len(w["spectrum"]) == len(w["spectrum_freqs"]) > 16
    assert max(w["spectrum"]) == 1.0
    peaks = np.asarray(w["peaks_hz"])
    assert any(abs(peaks - f).min() < 16.0 for f in (200.0, 450.0, 800.0, 1200.0))


def test_waveform_equals_the_references(tmp_path):
    """The same synthetic bank and impact through each package's synth and waveform
    panel: equal peaks, envelopes within 1e-5 x the peak."""
    ref, port = make_ref(tmp_path), make_app(tmp_path)
    ref._synth, ref._last_audio = synthetic_strike("mesheditor_tpu")
    port._synth, port._last_audio = synthetic_strike("mesheditor_tpu_torch", "cpu")
    a, b = ref.waveform(), port.waveform()
    assert a.keys() == b.keys()
    assert a["peaks_hz"] == b["peaks_hz"] and a["spectrum_freqs"] == b["spectrum_freqs"]
    peak = float(np.abs(ref._last_audio).max())
    for key in ("env_hi", "env_lo"):
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-5 * peak)
    assert ref.audio_state() == port.audio_state()


def test_solve_progress_recorded(tmp_path):
    app = make_app(tmp_path, audio=True)
    app.handle({"type": "add", "name": "cube"})
    app._ensure_synth()
    assert app.solve_progress, "no solve progress recorded"
    job = next(iter(app.solve_progress.values()))
    assert job["done"] and (job.get("modes", 0) > 0 or "error" in job)
    st = app.state()["audio"]
    assert st["solves"] and st["solves"][0]["done"]


def test_add_body_and_list(tmp_path):
    app = make_app(tmp_path)
    ent = app.handle({"type": "add", "kind": "cuboid"})["objects"][0]["entity"]
    app.handle({"type": "click_entity", "entity": ent})
    app.handle({"type": "add_body", "shape": "box"})
    p = app.physics_state()
    assert len(p["bodies"]) == 1
    b = p["bodies"][0]
    assert b["entity"] == ent and b["shape"] == "box" and b["motion"] == "static"
    assert {"mass", "is_dynamic", "gravity_factor", "shape_kind"} <= {f["name"] for f in b["fields"]}
    assert next(f for f in b["fields"] if f["name"] == "mass")["limits"] == [0.0, 1e5]
    assert p["world"]["bodies"] == 1 and p["world"]["dynamic"] == 0


def test_physics_edit_clamps_and_replays(tmp_path):
    from mesheditor_tpu_torch.scene.components import RigidBodyComponent

    app = make_app(tmp_path)
    ent = app.handle({"type": "add", "kind": "cuboid"})["objects"][0]["entity"]
    app.handle({"type": "add_body", "shape": "sphere", "entity": ent})  # nothing selected
    app.handle({"type": "click_entity", "entity": ent})
    app.handle({"type": "add_body", "shape": "sphere"})
    app.handle({"type": "physics_edit", "entity": ent, "field": "is_dynamic", "value": True})
    app.handle({"type": "physics_edit", "entity": ent, "field": "mass", "value": 2.5})
    app.handle({"type": "physics_edit", "entity": ent, "field": "gravity_factor", "value": 99.0})
    rb = app.registry.get(ent, RigidBodyComponent)
    assert rb.is_dynamic is True and rb.mass == 2.5 and rb.gravity_factor == 10.0  # clamped
    p = app.physics_state()
    assert p["bodies"][0]["motion"] == "dynamic" and p["world"]["dynamic"] == 1
    assert app.verify()["byte_exact"]


def test_inspect_lists_components_with_limits(tmp_path):
    app = make_app(tmp_path)
    ent = app.handle({"type": "add", "kind": "cuboid"})["objects"][0]["entity"]
    app.handle({"type": "click_entity", "entity": ent})
    p = app.inspect(ent)
    assert p["entity"] == ent and "Name" in p["components"]
    app.handle({"type": "field_edit", "entity": ent, "component": "ModalGainComponent",
                "field": "value", "value": 2.0})
    row = app.inspect(ent)["components"]["ModalGainComponent"][0]
    assert row["value"] == 2.0 and row["limits"] == [0.0, 10.0]
    assert app.inspect(99) == {"entity": 99, "components": {}}


def test_field_edit_clamps_and_replays(tmp_path):
    from mesheditor_tpu_torch.scene.components import ModalGainComponent

    app = make_app(tmp_path)
    ent = app.handle({"type": "add", "kind": "cuboid"})["objects"][0]["entity"]
    app.handle({"type": "field_edit", "entity": ent, "component": "ModalGainComponent",
                "field": "value", "value": 99.0})
    assert app.registry.get(ent, ModalGainComponent).value == 10.0  # clamped
    assert app.verify()["byte_exact"]


# ---- one event script through both packages ----

def event_script(seed=20261017):
    rng = np.random.default_rng(seed)
    return [
        {"type": "add", "kind": "cuboid"},
        {"type": "add", "kind": "torus"},
        {"type": "orbit", "dx": float(rng.integers(-80, 80)), "dy": float(rng.integers(-30, 30))},
        {"type": "zoom", "dy": 1},
        {"type": "click", "x": float(rng.integers(120, 200)), "y": float(rng.integers(70, 130))},
        {"type": "click_entity", "entity": 2},
        {"type": "field_edit", "entity": 1, "component": "ModalGainComponent", "field": "value",
         "value": float(rng.uniform(0.5, 3.0))},
        {"type": "add_body", "shape": "box"},
        {"type": "physics_edit", "entity": 2, "field": "mass", "value": float(rng.uniform(1, 5))},
        {"type": "physics_edit", "entity": 2, "field": "gravity_factor", "value": 99.0},
        {"type": "mode", "mode": "translate"},
        {"type": "add", "kind": "cone"},
        {"type": "click_entity", "entity": 3},
        {"type": "delete"},
        {"type": "mode", "mode": "select"},
        {"type": "click_entity", "entity": -1},
    ]


def _state(st):
    return {k: v for k, v in st.items() if k != "session_dir"}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Each package's ViewerApp after the event script, and the states it answered."""
    root = tmp_path_factory.mktemp("viewer_parity")
    apps, states = {}, {}
    for name, app in (("ref", make_ref(root)), ("port", make_app(root))):
        states[name] = [_state(app.handle(ev)) for ev in event_script()]
        app.session.log.drain()
        apps[name] = app
    return apps, states


def test_event_script_states_inspector_and_physics_equal(both):
    (apps, states) = both
    ref, port = apps["ref"], apps["port"]
    assert states["port"] == states["ref"]
    assert states["port"][4]["selected"] >= 0, "the scripted click hit nothing"
    for e in (1, 2, 3, 99):
        assert port.inspect(e) == ref.inspect(e), e
    assert port.physics_state() == ref.physics_state()
    assert port.physics_state()["bodies"][0]["fields"]
    np.testing.assert_array_equal(port.center, ref.center)
    assert port.radius == ref.radius


def test_event_script_logs_are_byte_equal(both):
    apps, _ = both
    logs = {k: (a.session.dir / "actions.log").read_bytes() for k, a in apps.items()}
    assert logs["port"] == logs["ref"] and logs["port"].count(b"\n") == 8


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")],
                         ids=["torch-to-jax", "jax-to-torch"])
def test_session_recorded_by_one_package_replays_in_the_other(both, writer, reader):
    from mesheditor_tpu.scene.session import verify_replay as ref_verify_replay

    apps, _ = both
    verify = verify_replay if reader == "port" else ref_verify_replay
    assert verify(apps[reader].registry, apps[writer].session.dir) is None
    assert apps[writer].verify()["byte_exact"]


def _contested(rend, pixels):
    return chip_smoke.contested_pixels(rend.gbuf.tri.cpu().numpy(), rend._tris, rend.clip,
                                       pixels)


def test_picks_and_frame_equal_the_references(both):
    """Picks on a 16x10 grid, and the frame with nothing selected within one step of the
    reference's, apart from contested pixels."""
    apps, _ = both
    ref, port = apps["ref"], apps["port"]
    frames = {k: decode_png(a.frame_png()) for k, a in apps.items()}
    rend_p, rend_r = port._current_renderer(), ref._current_renderer()
    grid = [(int((j + 0.5) * H / 10), int((i + 0.5) * W / 16)) for j in range(10)
            for i in range(16)]
    differ = [(y, x) for y, x in grid
              if rend_p.pick_entity(x, y) != rend_r.pick_entity(x, y)]
    assert all(_contested(rend_p, differ)), differ
    assert sum(rend_p.pick_entity(x, y) >= 0 for y, x in grid) > 20
    off = np.argwhere(np.abs(frames["port"].astype(np.int16)
                             - frames["ref"].astype(np.int16)).max(-1) > 1)
    assert all(_contested(rend_p, [tuple(p) for p in off])), off
    assert len(off) <= chip_smoke.CONTESTED_SHARE * W * H


def test_selection_tint_is_the_pick_mask_and_the_reference_draws_none(both):
    apps, _ = both
    ref, port = apps["ref"], apps["port"]
    base = {k: decode_png(a.frame_png()) for k, a in apps.items()}
    rend = port._current_renderer()
    picks = np.array([[rend.pick_entity(x, y) for x in range(W)] for y in range(H)])
    ent = int(np.bincount(picks[picks >= 0]).argmax())  # the entity most in view
    for a in (ref, port):
        a.handle({"type": "click_entity", "entity": ent})
    tinted = {k: decode_png(a.frame_png()) for k, a in apps.items()}
    np.testing.assert_array_equal(tinted["ref"], base["ref"])  # its tint never draws
    mask = picks == ent
    assert 0 < mask.sum() < mask.size
    np.testing.assert_array_equal(port._current_renderer().entity_mask(ent), mask)
    want = base["port"].copy()
    want[mask] = (0.6 * want[mask] + 0.4 * np.array([255, 160, 40])).astype(np.uint8)
    np.testing.assert_array_equal(tinted["port"], want)
    for a in (ref, port):
        a.handle({"type": "click_entity", "entity": -1})
    assert decode_png(port.frame_png()).tobytes() == base["port"].tobytes()


def test_strike_from_one_solved_model_sounds_the_same(tmp_path):
    """The reference solves the struck torus; its model, carried into the port, is struck
    at the same pixel through the port's synth. Both packages solve the same surface
    themselves too, and their frequencies agree. (A fresh solve may flip mode signs, so
    fresh audio is never compared across the packages.)"""
    ref, port = make_ref(tmp_path, audio=True), make_app(tmp_path, audio=True)
    for a in (ref, port):
        a.handle({"type": "add", "kind": "torus", "name": "ring"})
        a.handle({"type": "mode", "mode": "strike"})
    rend = ref._current_renderer()
    x = next(x for x in range(W // 2, W) if rend.pick_entity(x, H // 2) >= 0)  # the rim
    st_ref = ref.handle({"type": "click", "x": x, "y": H // 2})
    assert st_ref["has_audio"], st_ref["audio"]
    port._ensure_synth()
    own = port._synth_results[0].modes
    np.testing.assert_allclose(own.freqs, np.asarray(ref._synth_results[0].modes.freqs),
                               rtol=1e-6)
    carried = [convert.from_reference(r) for r in ref._synth_results]
    from mesheditor_tpu_torch.api import make_synth

    port._synth = make_synth(carried, device="cpu")
    port._synth_results = carried
    st_port = port.handle({"type": "click", "x": x, "y": H // 2})
    assert st_port["has_audio"] and st_port["selected"] == st_ref["selected"]
    a, b = np.asarray(ref._last_audio, np.float64), port._last_audio.astype(np.float64)
    peak = float(np.abs(a).max())
    assert peak > 0 and np.abs(b - a).max() < 5e-5 * peak
    assert ref.waveform()["peaks_hz"] == port.waveform()["peaks_hz"]
    assert port.audio_state() == ref.audio_state()


# ---- what the port does differently ----

def test_empty_scene_frames_the_origin_at_radius_3(tmp_path):
    port, ref = make_app(tmp_path), make_ref(tmp_path)
    assert port.radius == ref.radius == 3.0
    np.testing.assert_array_equal(port.center, np.zeros(3))
    assert decode_png(port.frame_png()).shape == (H, W, 3)


def test_ensure_synth_records_a_mesher_error_and_propagates_any_other(tmp_path, monkeypatch):
    from mesheditor_tpu_torch import api

    def refuse(*_a, **_k):
        raise ValueError("tetrahedralization failed: surface is not closed")

    app = make_app(tmp_path, audio=True)
    app.handle({"type": "add", "kind": "cuboid"})
    monkeypatch.setattr(api, "solve_surface", refuse)
    app._ensure_synth()
    job = app.solve_progress[1]
    assert job["done"] and job["error"].startswith("tetrahedralization failed")
    assert app._synth is None

    def crash(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(api, "solve_surface", crash)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        app._ensure_synth()


def test_viewer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        ViewerApp(width=W, height=H, session_root=tmp_path / "sess")
    assert not (tmp_path / "sess").exists(), "a session was opened before the refusal"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_inspect_answers_a_bad_query_with_400(tmp_path, capsys):
    app = make_app(tmp_path)
    app.handle({"type": "add", "kind": "cuboid"})
    server = serve(app, 0, block=False)
    try:
        port = server.server_address[1]
        assert f"viewer on http://127.0.0.1:{port}/" in capsys.readouterr().out
        base = f"http://127.0.0.1:{port}"
        for query in ("?entity=abc", "", "?entity=", "?other=1"):
            code, body = _get(f"{base}/inspect{query}")
            assert code == 400 and "error" in json.loads(body), query
        code, body = _get(f"{base}/inspect?entity=1")
        assert code == 200 and json.loads(body) == json.loads(json.dumps(app.inspect(1)))
        code, body = _get(f"{base}/state")
        assert code == 200 and json.loads(body)["objects"][0]["name"] == "cuboid"
        code, body = _get(f"{base}/frame")
        assert code == 200 and decode_png(body).shape == (H, W, 3)
        assert _get(f"{base}/audio")[0] == 404  # nothing struck yet
        req = urllib.request.Request(f"{base}/verify-replay", data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["byte_exact"]
    finally:
        server.shutdown()
        server.server_close()


def test_page_is_the_references():
    from mesheditor_tpu.app.page import PAGE_HTML as REF_PAGE

    assert port_viewer.PAGE_HTML == REF_PAGE
