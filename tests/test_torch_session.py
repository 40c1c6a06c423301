"""The action/replay layer of the port (scene/actions, field_edit, log, snapshot, session,
timeline, io/project) against the JAX package on the CPU: the same action sequence
applied in both packages gives the same snapshot bytes and the same action-log lines,
and a snapshot, a session or a project written by either package restores in the other
to the same bytes. Counterparts of tests/test_scene.py, tests/test_session.py (the
SIGKILL restore spawns the port), TestProject of tests/test_project_ply.py, TestFieldEdit
of tests/test_gizmo_fieldedit.py and TestTimeline of tests/test_timeline_samples.py."""

import importlib
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _package(root: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root, A=mod("scene.actions"), c=mod("scene.components"),
        Registry=mod("scene.registry").Registry, log=mod("scene.log"),
        snap=mod("scene.snapshot"), session=mod("scene.session"),
        derive=mod("scene.derive"), field_edit=mod("scene.field_edit"),
        timeline=mod("scene.timeline"), anim=mod("scene.animation"),
        project=mod("io.project"), mesh=mod("mesh"))


REF = _package("mesheditor_tpu")
PORT = _package("mesheditor_tpu_torch")
PACKAGES = pytest.mark.parametrize("P", [PORT, REF], ids=["torch", "jax"])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def demo_actions(P, rng=None):
    """tests/test_scene.py's demo scene, plus a seeded tail of every action kind (primitives,
    clamped field edits, tuning, strikes, a removal), as a list of `P`'s actions."""
    A = P.A
    rng = rng or np.random.default_rng(20261017)
    acts = [
        A.AddObject(name="bowl"), A.AddObject(name="mallet"),
        A.SetTransform(entity=1, translation=(0.1, 0.2, 0.3), scale=(2.0, 2.0, 2.0)),
        A.SetParent(entity=2, parent=1), A.SetTransform(entity=2, translation=(1.0, 0.0, 0.0)),
        A.SetAcousticMaterial(entity=1, name="Glass"), A.SetGain(entity=1, value=0.7),
        A.SetField(entity=1, component="SolveSettingsComponent", field_name="num_modes",
                   value=40),
        A.StrikeVertex(entity=1, vertex=3, impulse=(0.1, 0, 0), contact_time=2e-3),
    ]
    # "plane" is left out: the reference's AddPrimitive cannot build it
    # (test_plane_primitive_builds_in_the_port_only).
    for i, kind in enumerate(("cuboid", "torus", "uv_sphere", "cylinder", "cone", "icosphere",
                              "icosphere")):
        acts.append(A.AddPrimitive(name=f"p{i}", kind=kind, size=float(rng.uniform(0.05, 0.3)),
                                   detail=int(rng.integers(1, 3))))
    for e in range(3, 10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        acts += [
            A.SetTransform(entity=e, translation=tuple(rng.uniform(-1, 1, 3)),
                           rotation=tuple(q), scale=tuple(rng.uniform(0.5, 2.0, 3))),
            A.SetAcousticMaterial(entity=e, name=("Ceramic", "Iron", "Wood", "Plastic")[e % 4]),
            A.SetField(entity=e, component="AcousticMaterialRef", field_name="density",
                       value=float(rng.uniform(-10, 5e4))),  # clamped either way
            A.SetFundamental(entity=e, freq=float(rng.uniform(100, 3e4))),
            A.SetT60Scale(entity=e, scale=float(rng.uniform(0.0, 200.0))),
            A.SetGain(entity=e, value=float(rng.uniform(-1, 12))),
            A.SetModalModel(entity=e, path=f"{e:08x}.npz"),
            A.SilenceObject(entity=e),
        ]
    acts += [A.SetParent(entity=5, parent=3), A.RemoveObject(entity=9)]
    return acts


def build(P, actions, pipeline=True):
    """Apply `actions` one at a time with the derivation tick between them (the frame
    loop's contract). Returns the registry."""
    r = P.Registry()
    if pipeline:
        P.derive.install_default_pipeline(r)
    for a in actions:
        P.A.apply_action(r, a)
        r.process()
    return r


# ---- snapshots and the log, across packages ----

def test_same_actions_same_snapshot_bytes_in_both_packages():
    ref = build(REF, demo_actions(REF))
    port = build(PORT, demo_actions(PORT))
    snap = PORT.snap.snapshot_scene(port)
    assert snap == REF.snap.snapshot_scene(ref)
    assert len(snap) > 10_000  # seven primitive meshes travel in it


def test_action_log_lines_are_the_reference_lines(tmp_path):
    """Both logs written on their writer threads; drained before the compare."""
    files = {}
    for P in (PORT, REF):
        acts = demo_actions(P)
        build(P, acts)  # AddObject records the entity it allocated
        path = tmp_path / f"{P.root}.actions"
        log = P.log.ActionLog(path)
        for a in acts:
            log.record(a)
        log.drain()
        files[P.root] = path.read_bytes()
        log.close()
    assert files["mesheditor_tpu_torch"] == files["mesheditor_tpu"]
    assert files["mesheditor_tpu"].count(b"\n") == len(demo_actions(PORT))


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)], ids=["torch-to-jax",
                                                                            "jax-to-torch"])
def test_snapshot_written_by_one_package_restores_in_the_other(writer, reader):
    snap = writer.snap.snapshot_scene(build(writer, demo_actions(writer)))
    restored = reader.snap.restore_scene(snap)
    assert reader.snap.snapshot_scene(restored) == snap
    assert sorted(restored.entities()) == sorted(build(writer, demo_actions(writer)).entities())


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)], ids=["torch-to-jax",
                                                                            "jax-to-torch"])
def test_log_written_by_one_package_replays_in_the_other(tmp_path, writer, reader):
    acts = demo_actions(writer)
    live = build(writer, acts, pipeline=False)
    log = writer.log.ActionLog(tmp_path / "a.actions")
    for a in acts:
        log.record(a)
    log.close()
    replayed = reader.log.replay(reader.log.read_log(tmp_path / "a.actions"))
    assert reader.snap.snapshot_scene(replayed) == writer.snap.snapshot_scene(live)


# ---- tests/test_scene.py on the port ----

def test_field_clamping():
    A = PORT.A
    r = PORT.Registry()
    A.apply_action(r, A.AddObject(name="x"))
    A.apply_action(r, A.SetField(entity=1, component="AcousticMaterialRef",
                                 field_name="poisson_ratio", value=0.9))
    assert r.get(1, PORT.c.AcousticMaterialRef).poisson_ratio == 0.49
    A.apply_action(r, A.SetGain(entity=1, value=-5.0))
    assert r.get(1, PORT.c.ModalGainComponent).value == 0.0


def test_dead_entity_and_unknown_field_rejected():
    A = PORT.A
    r = PORT.Registry()
    with pytest.raises(A.ActionError):
        A.apply_action(r, A.SetGain(entity=42, value=1.0))
    A.apply_action(r, A.AddObject())
    with pytest.raises(A.ActionError):
        A.apply_action(r, A.SetField(entity=1, component="Transform", field_name="nope",
                                     value=1))
    with pytest.raises(A.ActionError, match="unknown material"):
        A.apply_action(r, A.SetAcousticMaterial(entity=1, name="Cheese"))


def test_parent_composition():
    r = build(PORT, demo_actions(PORT)[:9])
    w = r.get(2, PORT.c.WorldTransform).matrix
    # Child translated (1,0,0) under a parent scaled 2x translated (0.1,0.2,0.3).
    assert np.allclose(w[:3, 3], [2.1, 0.2, 0.3])


def test_log_roundtrip_encoding():
    for a in demo_actions(PORT):
        b = PORT.log.decode_action(PORT.log.encode_action(a))
        assert type(b) is type(a)
        assert PORT.log.encode_action(b) == PORT.log.encode_action(a)


def test_replay_reproduces_byte_exact_snapshot(tmp_path):
    acts = demo_actions(PORT)
    live = PORT.snap.snapshot_scene(build(PORT, acts))
    alog = PORT.log.ActionLog(tmp_path / "session.actions")
    for a in acts:
        alog.record(a)
    alog.close()
    replayed = PORT.log.replay(PORT.log.read_log(tmp_path / "session.actions"))
    assert PORT.snap.snapshot_scene(replayed) == live


def test_coverage_rule_over_the_ports_components():
    """verify_coverage holds over the port's PERSISTENT/DERIVED lists, which name the
    reference's classes one for one; a rogue component type is refused."""
    assert [t.__name__ for t in PORT.c.PERSISTENT_COMPONENTS] == \
        [t.__name__ for t in REF.c.PERSISTENT_COMPONENTS]
    assert [t.__name__ for t in PORT.c.DERIVED_COMPONENTS] == \
        [t.__name__ for t in REF.c.DERIVED_COMPONENTS]
    r = build(PORT, demo_actions(PORT))
    PORT.snap.verify_coverage(r)

    class Rogue:
        pass

    r._stores[Rogue][r.create()] = Rogue()
    with pytest.raises(RuntimeError, match="neither Persistent nor Derived"):
        PORT.snap.verify_coverage(r)


class _Hooks:
    def __init__(self):
        self.calls = []

    def strike(self, entity, vertex, impulse, contact_time):
        self.calls.append(("strike", entity, vertex, tuple(np.asarray(impulse)), contact_time))

    def silence(self, entity):
        self.calls.append(("silence", entity))


def test_strikes_and_silences_reach_only_the_synth_hooks():
    """StrikeVertex and SilenceObject touch no component: they go to `synth_hooks`, the
    same calls in both packages."""
    calls = {}
    for P in (PORT, REF):
        hooks = _Hooks()
        r = P.Registry()
        for a in demo_actions(P):
            P.A.apply_action(r, a, hooks)
        calls[P.root] = hooks.calls
    assert calls["mesheditor_tpu_torch"] == calls["mesheditor_tpu"]
    assert calls["mesheditor_tpu"][0] == ("strike", 1, 3, (0.1, 0.0, 0.0), 2e-3)
    assert sum(c[0] == "silence" for c in calls["mesheditor_tpu"]) == 7


def test_plane_primitive_builds_in_the_port_only():
    """The reference calls plane_surface(s, s), passing the size as segments, and raises;
    the port builds the s x s plane."""
    r = PORT.Registry()
    e = PORT.A.apply_action(r, PORT.A.AddPrimitive(name="floor", kind="plane", size=2.0))
    surf = r.get(e, PORT.c.MeshSurface)
    assert surf.triangles.shape == (2, 3)
    assert np.array_equal(np.ptp(surf.positions, axis=0), [2.0, 2.0, 0.0])
    with pytest.raises(TypeError):
        REF.A.apply_action(REF.Registry(), REF.A.AddPrimitive(kind="plane", size=2.0))


# ---- sessions (tests/test_session.py) ----

def _make_session(P, tmp_path, n_actions=3):
    s = P.session.Session(root=tmp_path / "sessions")
    for i in range(n_actions):
        s.apply(P.A.AddObject(name=f"obj{i}"))
        s.process()
    return s


def test_session_restore_matches_live(tmp_path):
    s = _make_session(PORT, tmp_path)
    s.apply(PORT.A.SetTransform(entity=2, translation=(1.0, 2.0, 3.0)))
    s.process()
    live = PORT.snap.snapshot_scene(s.registry)
    s.close()
    store = PORT.session.SessionStore(tmp_path / "sessions")
    assert PORT.snap.snapshot_scene(store.restore(store.list()[-1])) == live


def test_verify_replay_clean(tmp_path):
    s = _make_session(PORT, tmp_path)
    s.log.close()  # flush
    assert PORT.session.verify_replay(s.registry, s.dir) is None


def test_divergence_writes_fixture(tmp_path):
    s = _make_session(PORT, tmp_path)
    s.log.close()
    # Mutate the scene outside the action system: the invariant the self-test catches.
    PORT.A.apply_action(s.registry, PORT.A.AddObject(name="rogue"))
    s.registry.process()
    fixture = PORT.session.verify_replay(s.registry, s.dir, fixture_root=tmp_path / "fix")
    assert fixture is not None
    for name in ("actions.log", "live_snapshot.bin", "replayed_snapshot.bin"):
        assert (fixture / name).exists()
    assert "divergence" in (fixture / "report.txt").read_text()


def test_retention_prunes_old_sessions(tmp_path):
    root = tmp_path / "sessions"
    for _ in range(4):
        PORT.session.Session(root=root, retain=2).close()
    assert len(PORT.session.SessionStore(root).list()) <= 3  # 2 retained + the newest


def test_default_session_root_is_the_references(monkeypatch, tmp_path):
    monkeypatch.delenv("MESHEDITOR_TPU_SESSION_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert PORT.session.default_session_root() == REF.session.default_session_root() \
        == tmp_path / ".mesheditor_tpu" / "sessions"
    monkeypatch.setenv("MESHEDITOR_TPU_SESSION_DIR", str(tmp_path / "elsewhere"))
    assert PORT.session.SessionStore().root == tmp_path / "elsewhere"


@pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)], ids=["torch-to-jax",
                                                                            "jax-to-torch"])
def test_session_written_by_one_package_restores_in_the_other(tmp_path, writer, reader):
    s = writer.session.Session(root=tmp_path / "sessions")
    for a in demo_actions(writer):
        s.apply(a)
        s.process()
    live = writer.snap.snapshot_scene(s.registry)
    s.close()
    store = reader.session.SessionStore(tmp_path / "sessions")
    restored = store.restore(store.list()[-1])
    assert reader.snap.snapshot_scene(restored) == live
    assert reader.session.verify_replay(restored, store.list()[-1]) is None


def test_sigkill_mid_session_restores(tmp_path):
    """kill -9 a process of the port mid-session (JAX blocked in it); the restore dir
    replays to every action it flushed, in both packages."""
    root = tmp_path / "sessions"
    script = textwrap.dedent(f"""
        import sys, time
        sys.modules["jax"] = None
        sys.path.insert(0, {str(REPO)!r})
        from mesheditor_tpu_torch.scene import actions as A
        from mesheditor_tpu_torch.scene.session import Session
        s = Session(root={str(root)!r})
        for i in range(5):
            s.apply(A.AddObject(name=f"obj{{i}}"))
            s.process()
        s.apply(A.AddPrimitive(name="ring", kind="torus", size=0.1))
        s.log.drain()
        print("READY", flush=True)
        time.sleep(60)  # killed here
    """)
    proc = subprocess.Popen([sys.executable, "-u", "-c", script], stdout=subprocess.PIPE)
    try:
        assert "READY" in proc.stdout.readline().decode()
    finally:
        proc.kill()
    proc.wait()
    sessions = PORT.session.SessionStore(root).list()
    assert sessions, "the restore dir must survive the kill"
    r = PORT.session.SessionStore(root).restore(sessions[-1])
    names = {r.get(e, PORT.c.Name).value for e in r.entities() if r.has(e, PORT.c.Name)}
    assert {f"obj{i}" for i in range(5)} | {"ring"} <= names
    ref = REF.session.SessionStore(root).restore(sessions[-1])
    assert REF.snap.snapshot_scene(ref) == PORT.snap.snapshot_scene(r)


# ---- projects (TestProject of tests/test_project_ply.py) ----

@PACKAGES
def test_project_roundtrip_byte_exact(tmp_path, P):
    """Written by `P`, loaded by both packages to the same bytes."""
    r = build(P, demo_actions(P))
    P.project.save_project(tmp_path / "a.project", r)
    want = P.snap.snapshot_scene(r)
    assert PORT.snap.snapshot_scene(PORT.project.load_project(tmp_path / "a.project")) == want
    assert REF.snap.snapshot_scene(REF.project.load_project(tmp_path / "a.project")) == want


def test_project_bundles_modal_artifacts_and_the_log(tmp_path):
    r = PORT.Registry()
    PORT.A.apply_action(r, PORT.A.AddObject(name="obj"))
    modal_dir = tmp_path / "modal"
    modal_dir.mkdir()
    (modal_dir / "deadbeef.npz").write_bytes(b"fake")
    r.emplace(1, PORT.c.ModalModel("deadbeef.npz"))
    (tmp_path / "s.actions").write_text("{}\n")
    PORT.project.save_project(tmp_path / "b.project", r, modal_dir=modal_dir,
                              action_log_path=tmp_path / "s.actions")
    out = tmp_path / "restored"
    PORT.project.load_project(tmp_path / "b.project", extract_modal_to=out)
    assert (out / "deadbeef.npz").read_bytes() == b"fake"
    import zipfile

    with zipfile.ZipFile(tmp_path / "b.project") as z:
        assert sorted(z.namelist()) == ["modal/deadbeef.npz", "scene.snapshot",
                                        "session.actions"]


# ---- field edits (TestFieldEdit of tests/test_gizmo_fieldedit.py) ----

def test_editable_fields_with_limits():
    rows = PORT.field_edit.editable_fields(PORT.c.AcousticMaterialRef())
    by_name = {r["name"]: r for r in rows}
    assert by_name["density"]["limits"] == (1.0, 30_000.0)
    assert by_name["density"]["kind"] == "float"
    assert by_name["name"]["kind"] == "str"
    ref_rows = REF.field_edit.editable_fields(REF.c.AcousticMaterialRef())
    assert [(r["name"], r["kind"], r["limits"]) for r in rows] == \
        [(r["name"], r["kind"], r["limits"]) for r in ref_rows]


def test_edit_clamps_through_action():
    snaps = []
    for P in (PORT, REF):
        r = P.Registry()
        e = r.create()
        r.emplace(e, P.c.AcousticMaterialRef())
        P.field_edit.edit_field(r, e, P.c.AcousticMaterialRef, "density", 1e9)
        assert r.get(e, P.c.AcousticMaterialRef).density == 30_000.0
        snaps.append(P.snap.snapshot_scene(r))
    assert snaps[0] == snaps[1]


def test_describe_entity():
    r = PORT.Registry()
    e = r.create()
    r.emplace(e, PORT.c.AcousticMaterialRef())
    r.emplace(e, PORT.c.Transform())
    desc = PORT.field_edit.describe_entity(r, e)
    assert "AcousticMaterialRef" in desc
    kinds = {row["kind"] for row in desc.get("Transform", [])}
    assert kinds <= {"vec3", "vec4"} and kinds


# ---- the timeline (TestTimeline of tests/test_timeline_samples.py) ----

def _scene_with_clip(P):
    r = P.Registry()
    P.derive.install_default_pipeline(r)
    e = r.create()
    pos, tris = P.mesh.cuboid_surface((0.5, 0.5, 0.5))
    r.emplace(e, P.c.MeshSurface(positions=pos, triangles=np.asarray(tris, np.uint32)))
    r.emplace(e, P.c.Transform())
    clip = P.anim.AnimationClip("move", [P.anim.AnimationChannel(
        entity=e, path=P.anim.TargetPath.TRANSLATION, times=np.array([0.0, 1.0]),
        values=np.array([[0.0, 0, 0], [3.0, 0, 0]]),
        interpolation=P.anim.Interpolation.LINEAR)])
    return r, e, clip


def test_seek_evaluates_clip_and_derives():
    r, e, clip = _scene_with_clip(PORT)
    PORT.timeline.Timeline(r, clips=[clip], fps=30).seek(15)  # t = 0.5 s -> x = 1.5
    assert abs(r.get(e, PORT.c.Transform).translation[0] - 1.5) < 1e-12
    assert abs(r.get(e, PORT.c.WorldTransform).matrix[0, 3] - 1.5) < 1e-12


@pytest.mark.parametrize("loop", [True, False])
def test_tick_advances_loops_or_stops(loop):
    r, e, clip = _scene_with_clip(PORT)
    tl = PORT.timeline.Timeline(r, clips=[clip], fps=30)
    tl.state.end_frame = 3
    tl.state.loop = loop
    tl.play()
    frames = []
    for _ in range(6):
        tl.tick()
        frames.append(tl.state.frame)
    assert frames == ([1, 2, 3, 0, 1, 2] if loop else [1, 2, 3, 3, 3, 3])
    assert tl.state.playing == loop


def test_frames_iterator_fixed_step():
    r, e, clip = _scene_with_clip(PORT)
    tl = PORT.timeline.Timeline(r, clips=[clip], fps=30)
    tl.state.end_frame = 5
    assert list(tl.frames()) == [0, 1, 2, 3, 4, 5]


def test_baked_physics_playback_matches_the_reference():
    """A ball dropped on a plane, baked for 1.5 s and sampled: the port's poses are the
    reference's bit for bit at every sampled frame, and seeking back re-samples."""
    ys = {}
    for P in (PORT, REF):
        r = P.Registry()
        P.derive.install_default_pipeline(r)
        floor = r.create()
        r.emplace(floor, P.c.RigidBodyComponent(shape_kind="plane"))
        ball = r.create()
        r.emplace(ball, P.c.Transform(translation=np.array([0.0, 2.0, 0.0])))
        r.emplace(ball, P.c.RigidBodyComponent(shape_kind="sphere", radius=0.25,
                                               is_dynamic=True, mass=1.0))
        tl = P.timeline.Timeline(r, fps=30)
        tl.bake_physics(seconds=1.5)
        ys[P.root] = []
        for f in (0, 10, 20, 30, 44, 0):
            tl.seek(f)
            ys[P.root].append(r.get(ball, P.c.Transform).translation.copy())
    port, ref = np.array(ys["mesheditor_tpu_torch"]), np.array(ys["mesheditor_tpu"])
    assert np.array_equal(port, ref)
    y = port[:, 1]
    assert y[0] > y[1] > y[2] and y[4] < 0.6 and y[5] == y[0]
