"""Interactive viewer/editor shell: the frame-loop composition the reference runs as a
desktop app (the reference app's src/main.cpp:847-1185, ProcessEvents.cpp:776);
counterpart of mesheditor_tpu/app/viewer.py.

The "window" is a browser canvas served over HTTP from this process; the server loop
plays the role of the SDL/ImGui frame loop. Every repaint is the pipeline the reference's
SubmitViewport runs: actions applied at the single mutation point, the derivation tick
(`registry.process()`), flatten, rasterize and shade on the app's device. Every scene
mutation flows through the crash-recoverable action Session, so a live editing session
replays byte-exact (the main.cpp:409-423 self-test, exposed here as POST /verify-replay),
and a session recorded by either package replays in the other.

Interactions read the same device-produced buffers as the reference's GPU paths: click ->
entity/element picking from the ID G-buffer (selection/SelectionGpu.h), drag with a
transform mode active -> gizmo axis drag emitting SetTransform actions
(gizmo/TransformGizmo.cpp), strike mode -> pick a surface point and excite the modal
synth (TriggerModalStrike, AudioSystem.cpp:1290-1305), whose second of audio goes through
the impact resonator kernel on a CUDA device, with the rendered WAV streamed back to the
browser.

No third-party server dependency: python stdlib ThreadingHTTPServer + fetch-polling.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .._device import resolve_device
from ..render.camera import Camera, orbit_camera, view_projection
from ..render.gizmo import GizmoDrag, handle_points, pick_handle, ray_through_pixel
from ..render.record import encode_png
from ..render.scene_render import RenderSettings, SceneRenderer, flatten_scene, world_points
from ..scene import actions as A
from ..scene.components import MeshSurface, Name, Transform
from ..scene.registry import Registry
from ..scene.session import Session, verify_replay
from .page import PAGE_HTML

SELECTION_TINT = (255, 160, 40)


class ViewerApp:
    """State of one interactive session: scene, camera, selection, modes, synth. Frames,
    solves and the synth run on `device`; a CUDA device without a card raises here."""

    def __init__(self, registry: Optional[Registry] = None, width=960, height=600,
                 session_root=None, audio=False, device="cuda"):
        self.device = resolve_device(device)
        self.session = Session(registry, root=session_root)
        self.width = width
        self.height = height
        self.mode = "select"  # select | translate | rotate | scale | strike
        self.selected: int = -1
        self.drag: Optional[GizmoDrag] = None
        self._drag_handle = None
        self.azimuth, self.elevation, self.radius = -60.0, 25.0, 0.0
        self.center = np.zeros(3)
        self.version = 0
        self._frame_cache: tuple[int, bytes] | None = None
        self._lock = threading.RLock()
        self.audio_enabled = audio
        self._synth = None
        self._synth_objects: dict[int, int] = {}
        self._last_wav: bytes | None = None
        self._last_audio: np.ndarray | None = None
        # Live solve-progress overlay (reference: DrawModalJobsOverlay,
        # AudioSystem.cpp:1201-1218 job landing + main.cpp:1137): entity -> dict.
        # Written from the solving thread, read by /state polls (threaded server).
        self.solve_progress: dict[int, dict] = {}
        self.timeline_t = 0.0
        self._frame_camera()

    # ---- camera ----

    def _frame_camera(self):
        """Frame the drawn world-space vertices, read on the host; an empty scene frames
        the origin at radius 3."""
        r = self.registry
        r.process()
        pts = world_points(r, origin_if_empty=False)
        if len(pts) == 0:
            self.center, self.radius = np.zeros(3), 3.0
        else:
            lo, hi = pts.min(axis=0), pts.max(axis=0)
            self.center = (lo + hi) / 2
            self.radius = float(np.linalg.norm(hi - lo)) * 1.2 + 1e-3

    @property
    def registry(self) -> Registry:
        return self.session.registry

    def camera(self) -> Camera:
        return orbit_camera(self.center, self.radius, self.azimuth, self.elevation)

    # ---- repaint ----

    def _renderer(self) -> SceneRenderer:
        self.registry.process()
        batch = flatten_scene(self.registry, device=self.device)
        return SceneRenderer(batch, self.camera(),
                             RenderSettings(width=self.width, height=self.height))

    def frame_png(self) -> bytes:
        with self._lock:
            if self._frame_cache and self._frame_cache[0] == self.version:
                return self._frame_cache[1]
            rend = self._renderer()
            img = rend.image()
            img8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
            img8 = self._overlay(img8, rend)
            png = encode_png(img8)
            self._frame_cache = (self.version, png)
            self._renderer_cache = rend
            return png

    def _overlay(self, img8, rend: SceneRenderer):
        """Selection tint + gizmo handles, drawn host-side over the shaded frame (the
        reference draws these as extra GPU passes; the overlay is presentation, not
        scene state). The tint covers exactly the pixels that pick the selected entity."""
        if self.selected >= 0:
            sel = rend.entity_mask(self.selected)
            if sel.any():
                img8 = img8.copy()
                img8[sel] = (0.6 * img8[sel] + 0.4 * np.array(SELECTION_TINT)).astype(np.uint8)
            if self.mode in ("translate", "rotate", "scale"):
                img8 = self._draw_gizmo(img8)
        return img8

    def _gizmo_center(self):
        t = self.registry.get(self.selected, Transform)
        return np.asarray(t.translation, np.float64)

    def _draw_gizmo(self, img8):
        cam = self.camera()
        mvp = view_projection(cam, self.width, self.height)
        center = self._gizmo_center()
        size = self.radius * 0.18
        tips = handle_points(center, size)["tips"]
        colors = {0: (230, 70, 70), 1: (90, 220, 90), 2: (80, 120, 255)}

        def px(p):
            h = mvp @ np.append(p, 1.0)
            if h[3] <= 1e-9:
                return None
            x = (h[0] / h[3] * 0.5 + 0.5) * self.width
            y = (1 - (h[1] / h[3] * 0.5 + 0.5)) * self.height
            return np.array([x, y])

        img8 = img8.copy()
        o = px(center)
        for axis in (0, 1, 2):
            tip = px(tips[axis])
            if o is None or tip is None:
                continue
            n = max(int(np.abs(tip - o).max()) * 2, 2)
            ts = np.linspace(0, 1, n)
            line = (o[None, :] * (1 - ts[:, None]) + tip[None, :] * ts[:, None]).astype(int)
            ok = ((line[:, 0] >= 1) & (line[:, 0] < self.width - 1)
                  & (line[:, 1] >= 1) & (line[:, 1] < self.height - 1))
            line = line[ok]
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    img8[line[:, 1] + dy, line[:, 0] + dx] = colors[axis]
        return img8

    # ---- events ----

    def handle(self, ev: dict) -> dict:
        with self._lock:
            return self._handle(ev)

    def _handle(self, ev: dict) -> dict:
        t = ev.get("type")
        if t == "orbit":
            self.azimuth += float(ev.get("dx", 0)) * 0.4
            self.elevation = float(np.clip(self.elevation + float(ev.get("dy", 0)) * 0.4,
                                           -89, 89))
            self.version += 1
        elif t == "zoom":
            self.radius *= float(1.1 ** np.sign(ev.get("dy", 1)))
            self.version += 1
        elif t == "pan":
            cam = self.camera()
            fwd = self.center - cam.eye
            fwd /= np.linalg.norm(fwd)
            right = np.cross(fwd, cam.up)
            right /= np.linalg.norm(right)
            upv = np.cross(right, fwd)
            scale = self.radius * 0.002
            self.center = (self.center - right * float(ev.get("dx", 0)) * scale
                           + upv * float(ev.get("dy", 0)) * scale)
            self.version += 1
        elif t == "mode":
            self.mode = ev.get("mode", "select")
            self.version += 1
        elif t == "click":
            return self._click(float(ev["x"]), float(ev["y"]))
        elif t == "click_entity":
            self.selected = int(ev.get("entity", -1))
            self.version += 1
        elif t == "drag_start":
            return self._drag_start(float(ev["x"]), float(ev["y"]))
        elif t == "drag_move":
            return self._drag_move(float(ev["x"]), float(ev["y"]))
        elif t == "drag_end":
            return self._drag_end()
        elif t == "timeline":
            self._timeline(float(ev.get("t", 0.0)))
        elif t == "add":
            kinds = ("icosphere", "cuboid", "torus", "cylinder", "cone")
            kind = ev.get("kind") or kinds[len(self.state()["objects"]) % len(kinds)]
            self.session.apply(A.AddPrimitive(name=ev.get("name") or kind, kind=kind,
                                              size=1.0))
            self.session.process()
            self._frame_camera()
            self.version += 1
        elif t == "delete" and self.selected >= 0:
            self.session.apply(A.RemoveObject(entity=self.selected))
            self.selected = -1
            self.session.process()
            self.version += 1
        elif t == "frame":
            self._frame_camera()
            self.version += 1
        elif t == "field_edit":
            # Generic inspector edit: any registered component, through the same
            # single mutation point (SetField + FIELD_LIMITS clamp, replayable).
            ent = int(ev.get("entity", -1))
            comp = str(ev.get("component", ""))
            fname = str(ev.get("field", ""))
            if ent >= 0 and comp and fname:
                self.session.apply(A.SetField(
                    entity=ent, component=comp, field_name=fname,
                    value=ev.get("value")))
                self.session.process()
                self.version += 1
        elif t == "physics_edit":
            # Physics inspector edits route through the same single mutation point as
            # every other edit (SetField + FIELD_LIMITS clamp, logged/replayable); the
            # reference's PhysicsUi writes through its action dispatch too.
            ent = int(ev.get("entity", -1))
            fname = str(ev.get("field", ""))
            value = ev.get("value")
            if ent >= 0 and fname:
                self.session.apply(A.SetField(
                    entity=ent, component="RigidBodyComponent",
                    field_name=fname, value=value))
                self.session.process()
                self.version += 1
        elif t == "add_body":
            # Attach a default rigid body to the selected entity (PhysicsUi's "add
            # body" affordance).
            if self.selected >= 0:
                self.session.apply(A.SetField(
                    entity=self.selected, component="RigidBodyComponent",
                    field_name="shape_kind", value=str(ev.get("shape", "sphere"))))
                self.session.process()
                self.version += 1
        return self.state()

    def _click(self, x, y) -> dict:
        rend = self._current_renderer()
        if self.mode == "strike":
            return self._strike(rend, x, y)
        ent = rend.pick_entity(int(x), int(y))
        self.selected = int(ent)
        self.version += 1
        return self.state()

    def _current_renderer(self) -> SceneRenderer:
        self.frame_png()  # ensures the cache at the current version
        return self._renderer_cache

    def _drag_start(self, x, y) -> dict:
        if self.mode in ("translate", "rotate", "scale") and self.selected >= 0:
            cam = self.camera()
            center = self._gizmo_center()
            handle = pick_handle(cam, self.width, self.height, x, y, center,
                                 mode=self.mode, size=self.radius * 0.18)
            if handle is not None:
                t = self.registry.get(self.selected, Transform)
                self.drag = GizmoDrag(
                    handle=handle,
                    start_transform=Transform(
                        translation=np.asarray(t.translation, np.float64).copy(),
                        rotation=np.asarray(t.rotation, np.float64).copy(),
                        scale=np.asarray(t.scale, np.float64).copy()),
                    start_ray=ray_through_pixel(cam, self.width, self.height, x, y),
                )
                self._drag_handle = handle
        return self.state()

    def _drag_move(self, x, y) -> dict:
        """One SetTransform action per move, as the reference applies it (its comment
        says the action records on release; it does not)."""
        if self.drag is not None and self.selected >= 0:
            cam = self.camera()
            ray = ray_through_pixel(cam, self.width, self.height, x, y)
            new_t = self.drag.update(ray)
            self.session.apply(A.SetTransform(
                entity=self.selected, translation=tuple(new_t.translation),
                rotation=tuple(new_t.rotation), scale=tuple(new_t.scale)))
            self.session.process()
            self.version += 1
        return self.state()

    def _drag_end(self) -> dict:
        self.drag = None
        self._drag_handle = None
        return self.state()

    def _timeline(self, t: float):
        from ..scene.animation import AnimationClipComponent, evaluate_clip

        self.timeline_t = t
        r = self.registry
        for e in r.entities():
            if r.has(e, AnimationClipComponent):
                clip = r.get(e, AnimationClipComponent).clip
                evaluate_clip(r, clip, t)
        r.process()
        self.version += 1

    # ---- audio ----

    def _ensure_synth(self):
        """Solve every MeshSurface (as the reference does: CERAMIC, bbox/8, 16 modes, 6
        sample points, whatever material or stored model the entity carries) and build
        the synth over those with modes in band. A surface the mesher cannot mesh (its
        ValueError) is recorded in solve_progress; any other failure propagates."""
        if self._synth is not None or not self.audio_enabled:
            return
        from ..api import make_synth, solve_surface
        from ..materials import CERAMIC
        from ..types import ModalSolveSettings

        results, objects = [], {}
        r = self.registry
        for e in r.entities():
            if not r.has(e, MeshSurface):
                continue
            m = r.get(e, MeshSurface)
            ent = int(e)
            name = r.get(e, Name).value if r.has(e, Name) else str(ent)
            self.solve_progress[ent] = {"name": name, "fraction": 0.0, "done": False}

            def _prog(f, _ent=ent):
                self.solve_progress[_ent]["fraction"] = float(f)

            try:
                res = solve_surface(
                    np.asarray(m.positions, np.float64), np.asarray(m.triangles),
                    CERAMIC.properties,
                    settings=ModalSolveSettings(num_modes=16, num_vertices=6),
                    tet_resolution=8, progress=_prog, device=self.device)
                self.solve_progress[ent].update(fraction=1.0, done=True,
                                                modes=int(res.modes.num_modes))
            except ValueError as exc:
                self.solve_progress[ent].update(done=True, error=str(exc)[:120])
                continue
            if res.modes.num_modes:
                objects[int(e)] = len(results)
                results.append(res)
        if results:
            self._synth = make_synth(results, device=self.device)
            self._synth_results = results
            self._synth_objects = objects

    def _strike(self, rend: SceneRenderer, x, y) -> dict:
        ent = rend.pick_entity(int(x), int(y))
        if ent < 0:
            return self.state()
        self.selected = int(ent)
        self.version += 1
        vertex = 0
        el = rend.pick_element(int(x), int(y), "vertex")
        if el is not None and el >= 0:
            vertex = int(el)
        self.session.apply(A.StrikeVertex(entity=int(ent), vertex=vertex,
                                          impulse=(0.03, 0.05, 0.02)))
        self._ensure_synth()
        if self._synth is not None and int(ent) in self._synth_objects:
            from ..api import strike as strike_fn
            from ..io import write_wav
            from ..materials import CERAMIC

            obj = self._synth_objects[int(ent)]
            res = self._synth_results[obj]
            # The picked vertex clamped to a sample-point row, as the reference does (not
            # the nearest sample point).
            expos = min(vertex, max(res.modes.shapes.shape[0] - 1, 0))
            strike_fn(self._synth, obj, expos, res, direction=(0.2, 1.0, 0.1),
                      impulse_mag=0.05, material=CERAMIC.properties)
            audio = self._synth.render_seconds(1.0)
            peak = float(np.abs(audio).max())
            self._last_audio = audio
            if peak > 0:
                buf = io.BytesIO()
                write_wav(buf, audio / max(peak, 1e-9) * 0.7)
                self._last_wav = buf.getvalue()
        return self.state(struck=True)

    # ---- state for the client ----

    def state(self, **extra) -> dict:
        r = self.registry
        objects = []
        for e in r.entities():
            if r.has(e, Name):
                objects.append({"entity": int(e), "name": r.get(e, Name).value,
                                "selected": int(e) == self.selected})
        sel_name = next((o["name"] for o in objects if o["selected"]), None)
        st = {
            "version": self.version,
            "mode": self.mode,
            "selected": self.selected,
            "selected_name": sel_name,
            "objects": objects,
            "timeline_t": self.timeline_t,
            "has_audio": self._last_wav is not None,
            "session_dir": str(self.session.dir),
            "audio": self.audio_state(),
        }
        st.update(extra)
        return st

    def audio_state(self) -> dict:
        """Live audio-engine counters (reference: DrawAudioDebug bank-occupancy panel +
        ActiveVoices/ActiveImpacts/drop counters, AudioSystem.cpp:2020,
        ModalAudio.h:204-206) and the solve-progress overlay (DrawModalJobsOverlay,
        main.cpp:1137)."""
        s = self._synth
        return {
            "enabled": self.audio_enabled,
            "active_voices": int(s.active_voices) if s else 0,
            "active_impacts": int(s.active_impacts) if s else 0,
            "events_dropped": int(s.events_dropped) if s else 0,
            "voices_refused": int(s.voices_refused) if s else 0,
            "tracks_refused": int(s.tracks_refused) if s else 0,
            "bank_objects": int(s.params.coeff_re.shape[0]) if s else 0,
            "bank_modes": int(s.params.coeff_re.shape[1]) if s else 0,
            "solves": list(self.solve_progress.values()),
        }

    @staticmethod
    def _field_rows(rows) -> list:
        out = []
        for f in rows:
            v = f["value"]
            if f["kind"] == "bool":
                v = bool(v)
            elif f["kind"].startswith("vec"):
                v = [float(c) for c in np.asarray(v).reshape(-1)]
            elif f["kind"] in ("float", "int"):
                v = float(v)
            out.append({"name": f["name"], "kind": f["kind"], "value": v,
                        "limits": list(f["limits"]) if f["limits"] else None})
        return out

    def inspect(self, entity: int) -> dict:
        """Generic inspector payload for one entity: every registered component with its
        editable fields (reflection + FIELD_LIMITS; the reference's per-domain inspector
        windows, src/ui/FieldEdit.h, generated rather than hand-written). Edits route back
        through the `field_edit` event."""
        from ..scene.field_edit import describe_entity

        if not self.registry.valid(entity):
            return {"entity": entity, "components": {}}
        comps = {cname: self._field_rows(rows)
                 for cname, rows in describe_entity(self.registry, entity).items()}
        return {"entity": int(entity), "components": comps}

    def physics_state(self) -> dict:
        """Physics inspector payload (reference: PhysicsUi.cpp bodies/shapes/joints
        windows): every RigidBodyComponent with its editable motion/shape fields
        (reflection + FIELD_LIMITS) plus a built-world summary (shape kinds,
        dynamic/static split, joint list from the live PhysicsWorld)."""
        from ..scene.components import RigidBodyComponent
        from ..scene.field_edit import editable_fields

        r = self.registry
        bodies = []
        for e, rb in sorted(r.view(RigidBodyComponent)):
            bodies.append({
                "entity": int(e),
                "name": r.get(e, Name).value if r.has(e, Name) else f"#{e}",
                "shape": rb.shape_kind,
                "motion": ("dynamic" if rb.is_dynamic
                           else "kinematic" if rb.is_kinematic else "static"),
                "fields": self._field_rows(editable_fields(rb)),
            })
        world = {"bodies": 0, "dynamic": 0, "joints": []}
        if bodies:
            try:
                from ..physics.scene_build import build_world

                w, _handles = build_world(r)
                world = {
                    "bodies": len(w.bodies),
                    "dynamic": sum(1 for b in w.bodies.values() if not b.static),
                    "joints": [type(j).__name__ for j in getattr(w, "joints", [])],
                }
            except Exception as ex:  # host numpy: the inspector never takes the viewer down
                world = {"error": str(ex)[:200]}
        return {"bodies": bodies, "world": world}

    def waveform(self, points: int = 512, spectrum_bins: int = 256) -> dict:
        """Waveform envelope + magnitude spectrum of the last rendered strike for the
        browser panel (reference: ImPlot waveform/spectrum charts,
        AudioSystem.cpp:1527-1597). Pure-JSON payload, downsampled host-side."""
        a = self._last_audio
        if a is None or a.size == 0:
            return {"available": False}
        a = np.asarray(a, np.float64)
        n = a.size
        hop = max(n // points, 1)
        trimmed = a[: (n // hop) * hop].reshape(-1, hop)
        env_hi = trimmed.max(axis=1)
        env_lo = trimmed.min(axis=1)
        spec = np.abs(np.fft.rfft(a))
        sr = float(self._synth.sample_rate) if self._synth else 48000.0
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        keep = freqs <= 12000.0
        spec, freqs = spec[keep], freqs[keep]
        bins = max(spec.size // spectrum_bins, 1)
        spec_b = spec[: (spec.size // bins) * bins].reshape(-1, bins).max(axis=1)
        freq_b = freqs[: (freqs.size // bins) * bins].reshape(-1, bins).mean(axis=1)
        top = np.argsort(spec)[-6:][::-1]
        return {
            "available": True,
            "sample_rate": sr,
            "env_hi": np.round(env_hi, 6).tolist(),
            "env_lo": np.round(env_lo, 6).tolist(),
            "spectrum": np.round(spec_b / max(spec_b.max(), 1e-30), 5).tolist(),
            "spectrum_freqs": np.round(freq_b, 1).tolist(),
            "peaks_hz": np.round(freqs[top], 1).tolist(),
        }

    def verify(self) -> dict:
        self.session.log.drain()
        fixture = verify_replay(self.registry, self.session.dir)
        return {"byte_exact": fixture is None,
                "fixture": str(fixture) if fixture else None}


class _Handler(BaseHTTPRequestHandler):
    app: ViewerApp = None  # set by serve()

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code, body, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        app = self.app
        if self.path == "/" or self.path.startswith("/index"):
            self._send(200, PAGE_HTML.encode(), "text/html")
        elif self.path.startswith("/frame"):
            self._send(200, app.frame_png(), "image/png")
        elif self.path.startswith("/state"):
            self._send(200, json.dumps(app.state()).encode())
        elif self.path.startswith("/waveform"):
            self._send(200, json.dumps(app.waveform()).encode())
        elif self.path.startswith("/physics"):
            self._send(200, json.dumps(app.physics_state()).encode())
        elif self.path.startswith("/inspect"):
            q = parse_qs(urlparse(self.path).query)
            try:
                ent = int(q["entity"][0])
            except (KeyError, ValueError):
                self._send(400, json.dumps(
                    {"error": "inspect takes an integer entity, as /inspect?entity=3"}).encode())
                return
            self._send(200, json.dumps(app.inspect(ent)).encode())
        elif self.path.startswith("/audio"):
            wav = app._last_wav or b""
            self._send(200 if wav else 404, wav, "audio/wav")
        else:
            self._send(404, b"{}")

    def do_POST(self):
        app = self.app
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n) or b"{}")
        if self.path.startswith("/event"):
            self._send(200, json.dumps(app.handle(body)).encode())
        elif self.path.startswith("/verify-replay"):
            self._send(200, json.dumps(app.verify()).encode())
        else:
            self._send(404, b"{}")


def serve(app: ViewerApp, port: int = 8731, block: bool = True):
    """Serve `app` on 127.0.0.1:`port` (0 binds a free port). Prints the address it bound;
    blocks in the server loop, or with block=False serves from a daemon thread and returns
    the server (stop it with shutdown())."""
    handler = type("BoundHandler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    print(f"viewer on http://127.0.0.1:{server.server_address[1]}/ (session "
          f"{app.session.dir})", flush=True)
    if block:
        server.serve_forever()
    else:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
    return server
