"""glTF I/O of the port (io/gltf.py) against the JAX package on the CPU. Counterparts of
the 46 tests of tests/test_gltf.py, test_gltf_audio_ext.py, test_gltf_extensions.py,
test_gltf_physics_ext.py, test_gltf_textures.py and test_gltf_visual.py: each builds its
scene with the port's components, holds the port to the reference test's own assertions,
and holds the two packages to each other:

- every glTF/GLB file a test writes or hand-authors is imported by both packages, and the
  two snapshots are byte-equal (`same_import`). AnimationClipComponent does not snapshot
  in either package (`json.dumps` cannot encode an AnimationClip), so an animated scene
  is compared without it, and its clips channel by channel, bit for bit;
- a scene built the same way in both packages exports to the same file bytes when it
  carries no image (`same_export`); with images, the JSON is equal with the bufferViews'
  offsets and lengths and the buffer's length masked, every non-image bufferView holds the
  same bytes, and every image decodes to the same texels (the port writes PNG with zlib,
  the reference with PIL).

Renders run on the CPU through the port's plain PyTorch rasterizer, at the sizes the
reference tests use."""

import base64
import importlib
import io
import json
import struct
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

CPU = "cpu"


def _package(root: str) -> SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root, gltf=mod("io.gltf"), store=mod("io.model_store"), c=mod("scene.components"),
        Registry=mod("scene.registry").Registry, derive=mod("scene.derive"),
        anim=mod("scene.animation"), A=mod("scene.actions"), snap=mod("scene.snapshot"),
        mesh=mod("mesh"), types=mod("types"), env=mod("render.environment"),
        scene_build=mod("physics.scene_build"), orch=mod("solve.orchestration"))


REF = _package("mesheditor_tpu")
PORT = _package("mesheditor_tpu_torch")
SUFFIXES = pytest.mark.parametrize("suffix", [".gltf", ".glb"])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- the cross-package oracles ----

def _snapshot(P, r) -> tuple:
    """(snapshot bytes without AnimationClipComponent, the clips channel by channel)."""
    clips = list(r.view(P.anim.AnimationClipComponent))
    for e, _ in clips:
        r.remove(e, P.anim.AnimationClipComponent)
    try:
        snap = P.snap.snapshot_scene(r)
    finally:
        for e, comp in clips:
            r.emplace(e, comp)
        r.drain_events()
    channels = [(e, comp.clip.name, [(ch.entity, ch.path.value, ch.interpolation.value,
                                      ch.times.dtype.str, ch.times.tobytes(),
                                      ch.values.shape, ch.values.dtype.str, ch.values.tobytes())
                                     for ch in comp.clip.channels])
                for e, comp in clips]
    return snap, channels


def same_import(path, store_dir=None):
    """Import `path` with both packages (into the same store when given): the snapshots
    and the clips must be equal. Returns the port's registry."""
    port = PORT.gltf.import_gltf(path, store_dir=store_dir)
    ref = REF.gltf.import_gltf(path, store_dir=store_dir)
    assert _snapshot(PORT, port) == _snapshot(REF, ref)
    return port


def _read_doc(path):
    path = Path(path)
    if path.suffix == ".glb":
        raw = path.read_bytes()
        jlen, _ = struct.unpack_from("<II", raw, 12)
        doc = json.loads(raw[20:20 + jlen])
        off = 20 + jlen
        blob = raw[off + 8:] if off < len(raw) else b""
        return doc, blob
    doc = json.loads(path.read_text())
    bufs = doc.get("buffers") or []
    blob = (path.parent / bufs[0]["uri"]).read_bytes() if bufs and "uri" in bufs[0] else b""
    return doc, blob


def _pil_rgba(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def same_export(build, tmp_path, name, **kw):
    """Build the scene with `build(P)` in both packages and export it to
    <tmp>/<package>/<name>. Without images the files are byte-equal; with images the
    documents agree as the module docstring says. Returns the port's file."""
    paths = {}
    for P in (PORT, REF):
        d = tmp_path / P.root
        d.mkdir(exist_ok=True)
        paths[P.root] = d / name
        P.gltf.export_gltf(build(P), paths[P.root], **kw)
    port, ref = paths["mesheditor_tpu_torch"], paths["mesheditor_tpu"]
    (pdoc, pblob), (rdoc, rblob) = _read_doc(port), _read_doc(ref)
    if not rdoc.get("images"):
        assert port.read_bytes() == ref.read_bytes()
        if port.suffix == ".gltf" and rblob:
            assert pblob == rblob
        return port
    image_views = {img["bufferView"] for img in rdoc["images"]}
    assert len(pdoc["bufferViews"]) == len(rdoc["bufferViews"])
    for i, (pv, rv) in enumerate(zip(pdoc["bufferViews"], rdoc["bufferViews"])):
        p_bytes = pblob[pv["byteOffset"]:pv["byteOffset"] + pv["byteLength"]]
        r_bytes = rblob[rv["byteOffset"]:rv["byteOffset"] + rv["byteLength"]]
        if i in image_views:
            np.testing.assert_array_equal(_pil_rgba(p_bytes), _pil_rgba(r_bytes))
        else:
            assert p_bytes == r_bytes
    for doc in (pdoc, rdoc):
        for v in doc["bufferViews"]:
            v["byteOffset"] = v["byteLength"] = 0
        for b in doc["buffers"]:
            b["byteLength"] = 0
    assert pdoc == rdoc
    return port


# ---- tests/test_gltf.py ----

def basic_scene(P):
    A = P.A
    r = P.Registry()
    A.apply_action(r, A.AddObject(name="bowl"))
    A.apply_action(r, A.AddObject(name="mallet"))
    A.apply_action(r, A.SetTransform(entity=1, translation=(0.1, 0.2, 0.3),
                                     rotation=(0.9238795, 0.0, 0.3826834, 0.0),
                                     scale=(2.0, 2.0, 2.0)))
    A.apply_action(r, A.SetParent(entity=2, parent=1))
    A.apply_action(r, A.SetAcousticMaterial(entity=1, name="Glass"))
    pts, tris = P.mesh.icosphere_surface(1)
    r.emplace(1, P.c.MeshSurface(positions=pts, triangles=tris))
    r.emplace(1, P.c.SolveSettingsComponent(num_modes=40, min_mode_freq=30.0))
    r.emplace(1, P.c.ModalModel(path="abcd1234.npz"))
    return r


@SUFFIXES
def test_roundtrip(tmp_path, suffix):
    path = same_export(basic_scene, tmp_path, f"scene{suffix}")
    r2 = same_import(path)
    c = PORT.c
    names = {r2.get(e, c.Name).value for e in r2.entities()}
    assert names == {"bowl", "mallet"}
    bowl = next(e for e in r2.entities() if r2.get(e, c.Name).value == "bowl")
    mallet = next(e for e in r2.entities() if r2.get(e, c.Name).value == "mallet")
    t = r2.get(bowl, c.Transform)
    assert np.allclose(t.translation, [0.1, 0.2, 0.3])
    assert np.allclose(t.rotation, [0.9238795, 0.0, 0.3826834, 0.0], atol=1e-6)
    assert np.allclose(t.scale, 2.0)
    assert r2.get(mallet, c.SceneNode).parent == bowl
    mesh = r2.get(bowl, c.MeshSurface)
    pts, tris = PORT.mesh.icosphere_surface(1)
    assert np.allclose(mesh.positions, pts, atol=1e-6)
    assert np.array_equal(mesh.triangles, tris)
    mat = r2.get(bowl, c.AcousticMaterialRef)
    assert mat.name == "Glass" and mat.young_modulus == 6.2e10
    ss = r2.get(bowl, c.SolveSettingsComponent)
    assert ss.num_modes == 40 and ss.min_mode_freq == 30.0
    assert r2.get(bowl, c.ModalModel).path == "abcd1234.npz"


@SUFFIXES
def test_double_roundtrip_stable(tmp_path, suffix):
    g = PORT.gltf
    p1, p2 = tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"
    g.export_gltf(basic_scene(PORT), p1)
    g.export_gltf(g.import_gltf(p1), p2)
    if suffix == ".glb":
        assert p1.read_bytes() == p2.read_bytes()
    assert _snapshot(PORT, g.import_gltf(p1)) == _snapshot(PORT, same_import(p2))


def test_morph_roundtrip_and_blend(tmp_path):
    def build(P):
        pts, tris = P.mesh.icosphere_surface(1)
        reg = P.Registry()
        e = reg.create()
        reg.emplace(e, P.c.MeshSurface(positions=pts, triangles=tris,
                                       morph_targets=np.stack([pts * 0.3,
                                                               pts * np.array([0, -0.5, 0])]),
                                       morph_weights=np.array([0.5, 0.25])))
        return reg

    r2 = same_import(same_export(build, tmp_path, "morph.glb"))
    pts, _ = PORT.mesh.icosphere_surface(1)
    (e2,) = [x for x, _ in r2.view(PORT.c.MeshSurface)]
    m2 = r2.get(e2, PORT.c.MeshSurface)
    assert m2.morph_targets.shape == (2, pts.shape[0], 3)
    np.testing.assert_allclose(m2.morph_weights, [0.5, 0.25])
    expect = pts + 0.5 * pts * 0.3 + 0.25 * pts * np.array([0, -0.5, 0])
    np.testing.assert_allclose(m2.morphed_positions(), expect, atol=1e-6)


def test_animated_morph_weights_drive_blend():
    an = PORT.anim
    pts, tris = PORT.mesh.icosphere_surface(1)
    reg = PORT.Registry()
    e = reg.create()
    surf = PORT.c.MeshSurface(positions=pts, triangles=tris, morph_targets=pts[None] * 1.0,
                              morph_weights=np.zeros(1))
    reg.emplace(e, surf)
    clip = an.AnimationClip(channels=[an.AnimationChannel(
        entity=e, path=an.TargetPath.WEIGHTS, times=np.array([0.0, 1.0]),
        values=np.array([[0.0], [1.0]]), interpolation=an.Interpolation.LINEAR)])
    surf.morph_weights = an.evaluate_clip(reg, clip, 0.5)[e]
    np.testing.assert_allclose(surf.morphed_positions(), pts * 1.5, atol=1e-9)


# ---- tests/test_gltf_audio_ext.py ----

def synthetic_model(P, k=5, p=3, seed=0):
    rng = np.random.default_rng(seed)
    return P.types.ModalModes(
        freqs=np.linspace(400, 4000, k).astype(np.float32),
        t60s=np.linspace(0.8, 0.1, k).astype(np.float32),
        shapes=rng.standard_normal((p, k, 3)).astype(np.float32) * 0.01,
        positions=rng.standard_normal((p, 3)).astype(np.float32) * 0.05,
        indices=np.array([0, 1, 2], np.uint32),
    )


def audio_scene(P, store):
    reg = P.Registry()
    e = reg.create()
    pts, tris = P.mesh.icosphere_surface(1)
    reg.emplace(e, P.c.Name("bowl"))
    reg.emplace(e, P.c.MeshSurface(positions=pts * 0.05, triangles=tris))
    reg.emplace(e, P.c.AcousticMaterialRef(name="Glass", density=2600.0,
                                           young_modulus=6.2e10, poisson_ratio=0.2,
                                           alpha=2.0, beta=2e-7))
    reg.emplace(e, P.c.ModalGainComponent(value=1.5))
    mass = P.types.MassProperties(mass=0.31, center_of_mass=np.array([0.0, 0.01, 0.0]),
                                  inertia_diagonal=np.array([1e-4, 2e-4, 3e-4]))
    path = P.store.save_modal_model(store, synthetic_model(P), mass)
    reg.emplace(e, P.c.ModalModel(path=str(path)))
    return reg


def test_glb_roundtrip_embeds_model(tmp_path):
    glb = same_export(lambda P: audio_scene(P, tmp_path / "store"), tmp_path, "scene.glb")
    doc, _ = _read_doc(glb)
    ext = doc["extensions"]["KHR_audio_rigid_bodies"]
    assert len(ext["modalModels"]) == 1 and len(ext["acousticMaterials"]) == 1
    assert ext["acousticMaterials"][0]["youngsModulus"] == 6.2e10
    assert "massProperties" in ext["modalModels"][0]
    assert "KHR_audio_rigid_bodies" in doc["extensionsUsed"]
    r2 = same_import(glb, store_dir=tmp_path / "store2")
    (e2,) = [x for x, _ in r2.view(PORT.c.ModalModel)]
    mat = r2.get(e2, PORT.c.AcousticMaterialRef)
    assert mat.density == 2600.0 and abs(mat.poisson_ratio - 0.2) < 1e-12
    assert abs(r2.get(e2, PORT.c.ModalGainComponent).value - 1.5) < 1e-12
    modes = synthetic_model(PORT)
    m2, mass2 = PORT.store.load_modal_model(r2.get(e2, PORT.c.ModalModel).path)
    np.testing.assert_allclose(m2.freqs, modes.freqs, rtol=1e-6)
    np.testing.assert_allclose(m2.t60s, modes.t60s, rtol=1e-5)
    np.testing.assert_allclose(m2.shapes, modes.shapes, rtol=1e-6)
    np.testing.assert_array_equal(m2.indices, modes.indices)
    assert abs(mass2.mass - 0.31) < 1e-9


def test_imported_scene_plays_without_resolving(tmp_path):
    """Both packages store the embedded model under the same key and stamp the same
    input hash, so the port's SceneAudio loads it and solves nothing."""
    from mesheditor_tpu_torch.scene.audio_sync import SceneAudio

    glb = tmp_path / "scene.glb"
    PORT.gltf.export_gltf(audio_scene(PORT, tmp_path / "store"), glb)
    r2 = same_import(glb, store_dir=tmp_path / "store2")
    (e2, mm), = list(r2.view(PORT.c.ModalModel))
    ref = REF.gltf.import_gltf(glb, store_dir=tmp_path / "store3")
    (_, ref_mm), = list(ref.view(REF.c.ModalModel))
    assert Path(mm.path).name == Path(ref_mm.path).name and mm.inputs_hash == ref_mm.inputs_hash
    surf = r2.get(e2, PORT.c.MeshSurface)
    assert mm.inputs_hash == REF.orch.hash_solve_inputs(
        np.asarray(surf.positions, np.float64), np.asarray(surf.triangles, np.int64),
        np.zeros((0, 3)), np.ones(3), False, 1.0)
    sa = SceneAudio(r2, tmp_path / "store2", device=CPU)
    report = sa.reconcile()
    assert report.loaded and not report.solved  # fingerprint honoured, no eigensolve
    sa.strike(e2, 0, (0.1, 0.2, 0.05))
    out = sa.synth.render(2048)
    assert out.device.type == "cpu" and torch.isfinite(out).all() and out.abs().max() > 0


def test_invalid_material_and_model_fall_back(tmp_path, capfd):
    gltf_path = tmp_path / "scene.gltf"
    PORT.gltf.export_gltf(audio_scene(PORT, tmp_path / "store"), gltf_path)
    doc = json.loads(gltf_path.read_text())
    ext = doc["extensions"]["KHR_audio_rigid_bodies"]
    ext["acousticMaterials"][0]["density"] = -5.0       # invalid -> Ceramic default
    ext["modalModels"][0] = dict(ext["modalModels"][0], decayRates=9999)  # dangling accessor
    for node in doc["nodes"]:
        node.pop("extras", None)
    gltf_path.write_text(json.dumps(doc))
    r2 = same_import(gltf_path, store_dir=tmp_path / "store2")
    err = capfd.readouterr().err
    assert err.count("invalid density") == 2 and err.count("ignoring it") == 2  # both packages
    assert not list(r2.view(PORT.c.ModalModel))
    assert not list(r2.view(PORT.c.AcousticMaterialRef))


# ---- tests/test_gltf_physics_ext.py ----

def physics_scene(P):
    c = P.c
    reg = P.Registry()
    floor = reg.create()
    reg.emplace(floor, c.Name("floor"))
    reg.emplace(floor, c.RigidBodyComponent(shape_kind="plane",
                                            plane_normal=np.array([0.0, 1.0, 0.0])))
    ball = reg.create()
    reg.emplace(ball, c.Name("ball"))
    reg.emplace(ball, c.Transform(translation=np.array([0.0, 1.0, 0.0])))
    reg.emplace(ball, c.RigidBodyComponent(shape_kind="sphere", radius=0.1, is_dynamic=True,
                                           mass=2.0, linear_velocity=np.array([0.3, 0.0, 0.0])))
    crate = reg.create()
    reg.emplace(crate, c.Name("crate"))
    reg.emplace(crate, c.Transform(translation=np.array([1.0, 0.2, 0.0])))
    reg.emplace(crate, c.RigidBodyComponent(shape_kind="box",
                                            half_extents=np.array([0.2, 0.2, 0.2]),
                                            is_dynamic=True, mass=5.0))
    return reg


def test_physics_roundtrip(tmp_path):
    path = same_export(physics_scene, tmp_path, "scene.gltf")
    doc = json.loads(path.read_text())
    shapes = doc["extensions"]["KHR_implicit_shapes"]["shapes"]
    assert {s["type"] for s in shapes} == {"plane", "sphere", "box"}
    assert "KHR_physics_rigid_bodies" in doc["extensionsUsed"]
    assert shapes[[s["type"] for s in shapes].index("box")]["box"]["size"] == [0.4, 0.4, 0.4]
    r2 = same_import(path)
    c = PORT.c
    by_name = {r2.get(e, c.Name).value: rb for e, rb in r2.view(c.RigidBodyComponent)}
    assert len(by_name) == 3
    assert by_name["floor"].shape_kind == "plane" and not by_name["floor"].is_dynamic
    b = by_name["ball"]
    assert b.shape_kind == "sphere" and abs(b.radius - 0.1) < 1e-12
    assert b.is_dynamic and abs(b.mass - 2.0) < 1e-12
    np.testing.assert_allclose(b.linear_velocity, [0.3, 0.0, 0.0])
    np.testing.assert_allclose(by_name["crate"].half_extents, [0.2, 0.2, 0.2])


def _simulate(P, r, steps):
    world, handles = P.scene_build.build_world(r)
    for _ in range(steps):
        world.step()
    P.scene_build.write_back_poses(r, world, handles)
    return world, handles


def test_imported_scene_simulates(tmp_path):
    """One second of the imported scene: the port's poses are the reference's bit for bit."""
    path = same_export(physics_scene, tmp_path, "scene.glb")
    poses = {}
    for P in (PORT, REF):
        r2 = P.gltf.import_gltf(path)
        _, handles = _simulate(P, r2, 240)
        assert len(handles) == 3
        poses[P.root] = {r2.get(e, P.c.Name).value: r2.get(e, P.c.Transform).translation.copy()
                         for e, _ in r2.view(P.c.RigidBodyComponent) if r2.has(e, P.c.Transform)}
    port = poses["mesheditor_tpu_torch"]
    assert {k: v.tobytes() for k, v in port.items()} == \
        {k: v.tobytes() for k, v in poses["mesheditor_tpu"].items()}
    assert 0.05 < port["ball"][1] < 0.3 and port["ball"][0] > 0.1
    assert 0.1 < port["crate"][1] < 0.35


def test_mesh_collider_roundtrip_and_simulation(tmp_path):
    def build(P):
        reg = P.Registry()
        slab = reg.create()
        reg.emplace(slab, P.c.Name("slab"))
        pts, tris = P.mesh.grid_box_surface(3)
        reg.emplace(slab, P.c.MeshSurface(positions=pts * np.array([2.0, 0.2, 2.0]),
                                          triangles=tris))
        reg.emplace(slab, P.c.RigidBodyComponent(shape_kind="mesh"))
        ball = reg.create()
        reg.emplace(ball, P.c.Name("ball"))
        reg.emplace(ball, P.c.Transform(translation=np.array([0.7, 1.0, 0.7])))
        reg.emplace(ball, P.c.RigidBodyComponent(shape_kind="sphere", radius=0.05,
                                                 is_dynamic=True, mass=0.5))
        return reg

    r2 = same_import(same_export(build, tmp_path, "terrain.glb"))
    c = PORT.c
    by_name = {r2.get(e, c.Name).value: (e, rb) for e, rb in r2.view(c.RigidBodyComponent)}
    assert by_name["slab"][1].shape_kind == "mesh"
    world, handles = _simulate(PORT, r2, 480)
    p = world.bodies[handles[by_name["ball"][0]]].pos
    assert abs(p[1] - 0.25) < 0.02, p  # a radius above the slab's top at y = 0.2


# ---- tests/test_gltf_extensions.py ----

def material_scene(P, **vm_kwargs):
    r = P.Registry()
    P.derive.install_default_pipeline(r)
    e = r.create()
    r.emplace(e, P.c.Name("obj"))
    r.emplace(e, P.c.SceneNode())
    r.emplace(e, P.c.Transform())
    pts, tris = P.mesh.cuboid_surface((0.1, 0.1, 0.1))
    r.emplace(e, P.c.MeshSurface(positions=pts, triangles=tris))
    r.emplace(e, P.c.VisualMaterial(**vm_kwargs))
    r.drain_events()
    return r, e


FACTOR_FIELDS = dict(
    emissive_strength=3.5, unlit=True, ior=1.33, specular=0.7,
    specular_color=np.array([0.9, 0.8, 0.7]), clearcoat=0.8,
    clearcoat_roughness=0.25, sheen_color=np.array([0.2, 0.1, 0.05]),
    sheen_roughness=0.4, transmission=0.6, diffuse_transmission=0.3,
    diffuse_transmission_color=np.array([0.5, 0.6, 0.7]), thickness=0.02,
    attenuation_distance=0.15, attenuation_color=np.array([0.4, 0.9, 0.3]),
    dispersion=0.1, anisotropy_strength=0.5, anisotropy_rotation=0.7,
    iridescence=0.9, iridescence_ior=1.8, iridescence_thickness_min=150.0,
    iridescence_thickness_max=350.0, alpha_mode="MASK", alpha_cutoff=0.25,
)


def test_full_factor_set_roundtrips(tmp_path):
    path = same_export(lambda P: material_scene(P, **FACTOR_FIELDS)[0], tmp_path, "mat.glb")
    (_, vm2), = list(same_import(path).view(PORT.c.VisualMaterial))
    for key, want in FACTOR_FIELDS.items():
        got = getattr(vm2, key)
        if isinstance(want, np.ndarray):
            assert np.allclose(got, want), key
        elif isinstance(want, float):
            assert got == pytest.approx(want), key
        else:
            assert got == want, key


def test_extensions_declared(tmp_path):
    path = same_export(lambda P: material_scene(P, **FACTOR_FIELDS)[0], tmp_path, "mat.gltf")
    used = set(json.loads(path.read_text()).get("extensionsUsed", []))
    for name in ("KHR_materials_emissive_strength", "KHR_materials_unlit",
                 "KHR_materials_ior", "KHR_materials_specular", "KHR_materials_clearcoat",
                 "KHR_materials_sheen", "KHR_materials_transmission",
                 "KHR_materials_diffuse_transmission", "KHR_materials_volume",
                 "KHR_materials_dispersion", "KHR_materials_anisotropy",
                 "KHR_materials_iridescence"):
        assert name in used, name


def test_default_material_writes_no_extensions(tmp_path):
    path = same_export(lambda P: material_scene(P)[0], tmp_path, "plain.gltf")
    mat = json.loads(path.read_text())["materials"][0]
    assert "extensions" not in mat and "alphaMode" not in mat


def _render(r, width=64, height=48, camera=None):
    from mesheditor_tpu_torch.render.scene_render import RenderSettings, render_scene

    return render_scene(r, camera=camera, settings=RenderSettings(width=width, height=height),
                        device=CPU)


def _material_render(**vm_kwargs):
    return _render(material_scene(PORT, **vm_kwargs)[0]).image()


@pytest.mark.parametrize("case", ["unlit", "emissive_strength", "clearcoat", "transmission",
                                  "ior"])
def test_extension_shading(case):
    """TestExtensionShading's five cases: each extension factor changes the port's render
    as the reference test requires."""
    if case == "unlit":
        img = _material_render(unlit=True, base_color=np.array([0.5, 0.2, 0.1, 1.0]))
        base = _material_render(base_color=np.array([0.5, 0.2, 0.1, 1.0]))
        covered = np.abs(img - img[24, 32]).max(-1) < 1e-5
        assert covered.mean() > 0.2 and not np.allclose(img, base)
    elif case == "emissive_strength":
        dim = _material_render(emissive=np.array([0.1, 0.1, 0.1]))
        bright = _material_render(emissive=np.array([0.1, 0.1, 0.1]), emissive_strength=8.0)
        assert bright.mean() > dim.mean() + 0.01
    elif case == "clearcoat":
        base = _material_render(roughness=0.8)
        coated = _material_render(roughness=0.8, clearcoat=1.0, clearcoat_roughness=0.05)
        assert np.abs(coated - base).max() > 0.01
    elif case == "transmission":
        white = np.array([1.0, 1.0, 1.0, 1.0])
        opaque = _material_render(base_color=white)
        glassy = _material_render(base_color=white, transmission=0.9)
        assert np.abs(glassy - opaque).max() > 0.01
    else:
        base = _material_render(metallic=0.0, roughness=0.2)
        high_ior = _material_render(metallic=0.0, roughness=0.2, ior=2.4)
        assert np.abs(high_ior - base).max() > 0.005


def test_hidden_node_not_rendered_and_roundtrips(tmp_path):
    def build(P):
        r, e = material_scene(P, base_color=np.array([1.0, 0.0, 0.0, 1.0]))
        r.emplace(e, P.c.VisibilityComponent(visible=False))
        return r

    r, e = material_scene(PORT, base_color=np.array([1.0, 0.0, 0.0, 1.0]))
    shown = _render(r, 48, 32).image()
    hidden = _render(build(PORT), 48, 32).image()
    from mesheditor_tpu_torch.render.scene_render import RenderSettings

    assert np.allclose(hidden, np.asarray(RenderSettings().background), atol=1e-5)
    assert not np.allclose(shown, hidden)
    r2 = same_import(same_export(build, tmp_path, "vis.glb"))
    vis = [v for _, v in r2.view(PORT.c.VisibilityComponent)]
    assert len(vis) == 1 and vis[0].visible is False


def test_visibility_inherits_from_parent():
    r, e = material_scene(PORT)
    parent = r.create()
    r.emplace(parent, PORT.c.Name("group"))
    r.emplace(parent, PORT.c.SceneNode())
    r.emplace(parent, PORT.c.Transform())
    sn = r.get(e, PORT.c.SceneNode)
    sn.parent = parent
    r.emplace(e, sn)
    r.emplace(parent, PORT.c.VisibilityComponent(visible=False))
    r.drain_events()
    from mesheditor_tpu_torch.render.scene_render import RenderSettings

    img = _render(r, 32, 24).image()
    assert np.allclose(img, np.asarray(RenderSettings().background), atol=1e-5)


def _data_uri(blob: bytes) -> str:
    return "data:application/octet-stream;base64," + base64.b64encode(blob).decode()


def test_ext_mesh_gpu_instancing_imports_children(tmp_path):
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.array([0, 1, 2], np.uint32)
    t_arr = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
    s_arr = np.array([[1, 1, 1], [2, 2, 2], [1, 1, 3]], np.float32)
    blob = pts.tobytes() + tris.tobytes() + t_arr.tobytes() + s_arr.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"name": "grid", "mesh": 0, "extensions": {"EXT_mesh_gpu_instancing": {
            "attributes": {"TRANSLATION": 2, "SCALE": 3}}}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3",
             "min": [0, 0, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5125, "count": 3, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 3, "componentType": 5126, "count": 3, "type": "VEC3"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 12},
            {"buffer": 0, "byteOffset": 48, "byteLength": 36},
            {"buffer": 0, "byteOffset": 84, "byteLength": 36}],
        "buffers": [{"byteLength": len(blob), "uri": _data_uri(blob)}],
        "extensionsUsed": ["EXT_mesh_gpu_instancing"],
    }
    path = tmp_path / "inst.gltf"
    path.write_text(json.dumps(doc))
    r = same_import(path)
    meshes = list(r.view(PORT.c.MeshSurface))
    assert len(meshes) == 3  # one entity per instance; the carrier node holds none
    trs = sorted(tuple(np.asarray(r.get(e, PORT.c.Transform).translation)) for e, _ in meshes)
    assert trs == [(0.0, 0.0, 0.0), (0.0, 2.0, 0.0), (2.0, 0.0, 0.0)]
    scales = {tuple(np.asarray(r.get(e, PORT.c.Transform).scale)) for e, _ in meshes}
    assert (1.0, 1.0, 3.0) in scales and (2.0, 2.0, 2.0) in scales


def test_webp_export_import_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    tex = rng.integers(0, 255, (8, 8, 4), np.uint8)
    tex[..., 3] = 255

    def build(P):
        pts, tris = P.mesh.cuboid_surface((0.1, 0.1, 0.1))
        r = P.Registry()
        P.derive.install_default_pipeline(r)
        e = r.create()
        r.emplace(e, P.c.Name("tex"))
        r.emplace(e, P.c.SceneNode())
        r.emplace(e, P.c.Transform())
        r.emplace(e, P.c.MeshSurface(positions=pts, triangles=tris, uvs=np.abs(pts[:, :2]) * 5))
        r.emplace(e, P.c.VisualMaterial(texture=tex))
        r.drain_events()
        return r

    path = same_export(build, tmp_path, "webp.glb", texture_format="webp")
    (_, vm2), = list(same_import(path).view(PORT.c.VisualMaterial))
    assert vm2.texture.shape == tex.shape and np.array_equal(vm2.texture, tex)  # lossless


def test_webp_marked_required(tmp_path):
    path = same_export(
        lambda P: material_scene(P, texture=np.full((4, 4, 4), 128, np.uint8))[0],
        tmp_path, "webp.gltf", texture_format="webp")
    doc = json.loads(path.read_text())
    assert "EXT_texture_webp" in doc.get("extensionsUsed", [])
    assert "EXT_texture_webp" in doc.get("extensionsRequired", [])
    assert doc["images"][0]["mimeType"] == "image/webp"
    assert "source" not in doc["textures"][0]


def test_quantized_positions_ingest(tmp_path):
    """KHR_mesh_quantization: normalized uint16 POSITION and a compensating node scale.
    (The reference's first TestMeshQuantization class, shadowed there by the second.)"""
    pos_f = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float64)
    q = np.round(pos_f * 65535.0).astype(np.uint16)
    tris = np.array([0, 1, 2], np.uint32)
    blob = q.tobytes() + b"\x00" * ((-q.nbytes) % 4) + tris.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "scale": [2.0, 2.0, 2.0]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5123, "count": 3, "type": "VEC3",
             "normalized": True},
            {"bufferView": 1, "componentType": 5125, "count": 3, "type": "SCALAR"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": q.nbytes},
            {"buffer": 0, "byteOffset": q.nbytes + ((-q.nbytes) % 4), "byteLength": 12}],
        "buffers": [{"byteLength": len(blob), "uri": _data_uri(blob)}],
        "extensionsUsed": ["KHR_mesh_quantization"],
        "extensionsRequired": ["KHR_mesh_quantization"],
    }
    path = tmp_path / "quant.gltf"
    path.write_text(json.dumps(doc))
    r = same_import(path)
    (e, surf), = list(r.view(PORT.c.MeshSurface))
    assert np.allclose(surf.positions, pos_f, atol=1e-4)
    assert np.allclose(r.get(e, PORT.c.Transform).scale, 2.0)


def test_quantized_positions_load_within_tolerance(tmp_path):
    """int16 POSITION with node-scale dequantization, appended to an exported file."""
    src = tmp_path / "plain.gltf"
    PORT.gltf.export_gltf(material_scene(PORT)[0], src)
    gltf = json.loads(src.read_text())
    buffers = PORT.gltf._read_buffer(gltf, src, None)
    acc = gltf["accessors"][gltf["meshes"][0]["primitives"][0]["attributes"]["POSITION"]]
    bv = gltf["bufferViews"][acc["bufferView"]]
    raw = buffers[bv.get("buffer", 0)][bv.get("byteOffset", 0):][: bv["byteLength"]]
    pos = np.frombuffer(raw, np.float32).reshape(-1, 3)
    lo, hi = pos.min(0), pos.max(0)
    scale = np.maximum((hi - lo) / 2.0, 1e-12)
    ctr = (hi + lo) / 2.0
    q = np.round((pos - ctr) / scale * 32767.0).astype(np.int16)
    gltf["buffers"].append({"uri": _data_uri(q.tobytes()), "byteLength": q.nbytes})
    gltf["bufferViews"].append({"buffer": len(gltf["buffers"]) - 1, "byteOffset": 0,
                                "byteLength": q.nbytes})
    gltf["accessors"].append({"bufferView": len(gltf["bufferViews"]) - 1, "componentType": 5122,
                              "count": int(q.shape[0]), "type": "VEC3",
                              "min": q.min(0).tolist(), "max": q.max(0).tolist()})
    gltf["meshes"][0]["primitives"][0]["attributes"]["POSITION"] = len(gltf["accessors"]) - 1
    node = gltf["nodes"][0]
    node["scale"] = (np.asarray(node.get("scale", [1, 1, 1])) * scale / 32767.0).tolist()
    node["translation"] = (np.asarray(node.get("translation", [0, 0, 0])) + ctr).tolist()
    gltf["extensionsUsed"] = gltf.get("extensionsUsed", []) + ["KHR_mesh_quantization"]
    out = tmp_path / "quant.gltf"
    out.write_text(json.dumps(gltf))
    r2 = same_import(out)
    (e2, surf), = list(r2.view(PORT.c.MeshSurface))
    tr = r2.get(e2, PORT.c.Transform)
    world = np.asarray(surf.positions, np.float64) * np.asarray(tr.scale) + tr.translation
    assert np.abs(world - pos).max() <= np.abs(scale).max() / 32767.0 * 1.5


def _meshopt_tagged(tmp_path, keep_fallback):
    src = tmp_path / "plain.gltf"
    PORT.gltf.export_gltf(material_scene(PORT)[0], src)
    gltf = json.loads(src.read_text())
    prim = gltf["meshes"][0]["primitives"][0]
    acc = gltf["accessors"][prim["attributes"]["POSITION"]]
    bv = gltf["bufferViews"][acc["bufferView"]]
    bv.setdefault("extensions", {})["EXT_meshopt_compression"] = {
        "buffer": 0, "byteOffset": 0, "byteLength": 4, "byteStride": 12,
        "count": acc["count"], "mode": "ATTRIBUTES"}
    if not keep_fallback:
        gltf["buffers"][bv.get("buffer", 0)] = {"byteLength": 0}
    gltf.setdefault("extensionsUsed", []).append("EXT_meshopt_compression")
    out = tmp_path / "mo.gltf"
    out.write_text(json.dumps(gltf))
    return out


def test_meshopt_fallback_buffer_loads(tmp_path):
    assert len(list(same_import(_meshopt_tagged(tmp_path, True)).view(PORT.c.MeshSurface))) == 1


def test_meshopt_without_fallback_rejected_with_clear_error(tmp_path):
    out = _meshopt_tagged(tmp_path, False)
    for P in (PORT, REF):
        with pytest.raises(ValueError, match="meshopt"):
            P.gltf.import_gltf(out)


def variants_scene(P):
    r, e = material_scene(P, base_color=np.array([1.0, 1.0, 1.0, 1.0]))
    red = {"pbrMetallicRoughness": {"baseColorFactor": [1.0, 0.0, 0.0, 1.0]},
           "extensions": {"KHR_materials_ior": {"ior": 1.8}}}
    blue = {"pbrMetallicRoughness": {"baseColorFactor": [0.0, 0.0, 1.0, 1.0]}}
    r.emplace(e, P.c.MaterialVariants(names=["Red", "Blue"],
                                      mappings=[{"variants": [0], "material": red},
                                                {"variants": [1], "material": blue}]))
    return r


def test_variants_roundtrip_and_apply(tmp_path):
    path = same_export(variants_scene, tmp_path, "variants.glb")
    r2 = same_import(path)
    (e2, mv2), = list(r2.view(PORT.c.MaterialVariants))
    assert mv2.names == ["Red", "Blue"] and len(mv2.mappings) == 2
    assert PORT.gltf.apply_variant(r2, "Red") == 1
    vm = r2.get(e2, PORT.c.VisualMaterial)
    assert np.allclose(vm.base_color, [1.0, 0.0, 0.0, 1.0]) and vm.ior == pytest.approx(1.8)
    ref = REF.gltf.import_gltf(path)
    REF.gltf.apply_variant(ref, "Red")
    assert _snapshot(PORT, r2) == _snapshot(REF, ref)
    PORT.gltf.apply_variant(r2, "Blue")
    assert np.allclose(r2.get(e2, PORT.c.VisualMaterial).base_color, [0.0, 0.0, 1.0, 1.0])


def test_document_declares_variants(tmp_path):
    def build(P):
        r, e = material_scene(P)
        r.emplace(e, P.c.MaterialVariants(names=["A"],
                                          mappings=[{"variants": [0], "material": {}}]))
        return r

    doc = json.loads(same_export(build, tmp_path, "v.gltf").read_text())
    assert doc["extensions"]["KHR_materials_variants"]["variants"] == [{"name": "A"}]
    assert "KHR_materials_variants" in doc["extensionsUsed"]


def test_ibl_roundtrip_and_render(tmp_path):
    """EXT_lights_image_based: the equirect goes out as six PNG cube faces (the port's
    zlib PNG) and SH9, and comes back the same in both packages; it lights the render."""
    env = np.zeros((32, 64, 3), np.float32)
    env[:16] = (0.8, 0.5, 0.2)
    env[16:] = (0.05, 0.1, 0.2)

    def build(P):
        r, e = material_scene(P, metallic=0.9, roughness=0.15)
        r.emplace(e, P.c.ImageBasedLightComponent(equirect=env, intensity=2.0))
        return r

    doc_r = same_import(same_export(build, tmp_path, "ibl.glb"))
    comps = list(doc_r.view(PORT.c.ImageBasedLightComponent))
    assert len(comps) == 1
    got = comps[0][1]
    assert got.intensity == pytest.approx(2.0) and got.equirect.size > 0
    h = got.equirect.shape[0]
    top = got.equirect[: h // 3].mean(axis=(0, 1))
    bot = got.equirect[-h // 3:].mean(axis=(0, 1))
    assert top[0] > bot[0] and bot[2] > top[2] * 0.2
    lit = _render(doc_r).image()
    doc_r.remove(comps[0][0], PORT.c.ImageBasedLightComponent)
    unlit = _render(doc_r).image()
    assert np.abs(lit - unlit).max() > 0.02


def test_sh9_fallback():
    env = np.zeros((16, 32, 3), np.float32)
    env[:8] = (1.0, 1.0, 1.0)
    coeffs = PORT.env.sh9_irradiance_coefficients(env)
    np.testing.assert_array_equal(coeffs, REF.env.sh9_irradiance_coefficients(env))
    rec = PORT.env.equirect_from_sh9(coeffs, height=16)
    assert rec[:4].mean() > rec[-4:].mean()  # the bright top survives


# ---- tests/test_gltf_textures.py ----

def _checker(val_a, val_b, n=16):
    yy, xx = np.mgrid[0:n, 0:n]
    m = ((xx // 4 + yy // 4) % 2).astype(np.uint8)
    tex = np.zeros((n, n, 4), np.uint8)
    tex[..., :3] = np.where(m[..., None] > 0, val_a, val_b)
    tex[..., 3] = 255
    return tex


def textured_registry(P):
    r = P.Registry()
    e = r.create()
    r.emplace(e, P.c.Name("crate"))
    r.emplace(e, P.c.Transform())
    pts, tris = P.mesh.cuboid_surface((0.5, 0.5, 0.5))
    p = np.asarray(pts)
    uv = (p[:, :2] - p[:, :2].min(0)) / np.ptp(p[:, :2], axis=0)
    r.emplace(e, P.c.MeshSurface(positions=p, triangles=np.asarray(tris, np.uint32), uvs=uv))
    r.emplace(e, P.c.VisualMaterial(
        base_color=np.array([1.0, 0.9, 0.8, 1.0]), emissive=np.array([1.0, 1.0, 1.0]),
        texture=_checker((200, 60, 40), (40, 60, 200)),
        mr_texture=_checker((0, 255, 0), (0, 40, 255)),
        emissive_texture=_checker((255, 120, 0), (0, 0, 0)),
        normal_texture=_checker((128, 128, 255), (180, 128, 230)),
        occlusion_texture=_checker((255, 255, 255), (60, 60, 60)),
        uv_transform=np.array([0.25, 0.1, 0.3, 2.0, 3.0]),
    ))
    return r


TEXTURE_FIELDS = ("texture", "mr_texture", "emissive_texture", "normal_texture",
                  "occlusion_texture")


@SUFFIXES
def test_all_texture_kinds_roundtrip(tmp_path, suffix):
    path = same_export(textured_registry, tmp_path, f"tex{suffix}")
    doc, _ = _read_doc(path)
    m = doc["materials"][0]
    assert "metallicRoughnessTexture" in m["pbrMetallicRoughness"]
    assert "emissiveTexture" in m and "normalTexture" in m and "occlusionTexture" in m
    assert "KHR_texture_transform" in doc.get("extensionsUsed", [])
    assert all(img["mimeType"] == "image/png" for img in doc["images"])
    (_, vm2), = same_import(path).view(PORT.c.VisualMaterial)
    vm1 = textured_registry(PORT).get(1, PORT.c.VisualMaterial)
    for f in TEXTURE_FIELDS:
        np.testing.assert_array_equal(getattr(vm1, f), getattr(vm2, f), err_msg=f)
    np.testing.assert_allclose(vm2.uv_transform, vm1.uv_transform, atol=1e-12)


def test_textures_change_the_render():
    r = textured_registry(PORT)
    PORT.derive.install_default_pipeline(r)
    full = _render(r, 96, 64).image()
    vm = r.get(1, PORT.c.VisualMaterial)
    vm.normal_texture = np.zeros((0, 0, 4), np.uint8)
    vm.emissive_texture = np.zeros((0, 0, 4), np.uint8)
    plain = _render(r, 96, 64).image()
    assert np.abs(full - plain).max() > 0.02, "normal/emissive textures must change shading"


def _ktx2_bytes(w, h, rgba, scheme=0):
    level = rgba.tobytes()
    comp = level
    if scheme == 2:
        import zstandard

        comp = zstandard.ZstdCompressor().compress(level)
    elif scheme == 3:
        import zlib

        comp = zlib.compress(level)
    header = b"\xabKTX 20\xbb\r\n\x1a\n" + struct.pack("<IIIIIIIII", 43, 1, w, h, 0, 0, 1, 1,
                                                      scheme)
    header += struct.pack("<IIIIQQ", 0, 0, 0, 0, 0, 0)
    off = len(header) + 24
    header += struct.pack("<QQQ", off, len(comp), len(level))
    return header + comp


@pytest.mark.parametrize("scheme", [0, 2, 3], ids=["raw", "zstd", "zlib"])
def test_ktx2_decode(scheme):
    rgba = _checker((10, 200, 30), (200, 10, 30), n=8)
    blob = _ktx2_bytes(8, 8, rgba, scheme)
    np.testing.assert_array_equal(PORT.gltf._decode_ktx2(blob), rgba)
    np.testing.assert_array_equal(REF.gltf._decode_ktx2(blob), rgba)


def _basisu_doc(uri):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    blob0 = pos.tobytes() + uv.tobytes() + idx.tobytes() + b"\x00\x00"
    return {
        "asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "textures": [{"extensions": {"KHR_texture_basisu": {"source": 0}}}],
        "images": [{"uri": uri}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3",
             "min": [0, 0, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5126, "count": 3, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 3, "type": "SCALAR"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 24},
            {"buffer": 0, "byteOffset": 60, "byteLength": 6}],
        "buffers": [{"byteLength": len(blob0), "uri": _data_uri(blob0)}],
    }


def test_ktx2_through_gltf_basisu_texture(tmp_path):
    rgba = _checker((9, 9, 9), (250, 250, 250), n=8)
    blob = _ktx2_bytes(8, 8, rgba, scheme=2)
    p = tmp_path / "basisu.gltf"
    p.write_text(json.dumps(_basisu_doc("data:application/ktx2;base64,"
                                        + base64.b64encode(blob).decode())))
    (_, vm), = same_import(p).view(PORT.c.VisualMaterial)
    np.testing.assert_array_equal(vm.texture, rgba)


def _foreign_doc(**kw):
    doc = {"asset": {"version": "2.0", "generator": "ThirdPartyDCC 1.2"},
           "scenes": [{"nodes": [0]}], "scene": 0, "nodes": [{"mesh": 0, "name": "foreign"}]}
    doc.update(kw)
    return doc


def test_interleaved_vertex_buffer(tmp_path):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    inter = np.concatenate([pos, uv], axis=1).astype(np.float32)  # stride 20
    blob = inter.tobytes() + np.array([0, 1, 2], np.uint8).tobytes() + b"\x00"
    p = tmp_path / "interleaved.gltf"
    p.write_text(json.dumps(_foreign_doc(
        meshes=[{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                 "indices": 2}]}],
        accessors=[
            {"bufferView": 0, "byteOffset": 0, "componentType": 5126, "count": 3,
             "type": "VEC3", "min": [0, 0, 0], "max": [1, 1, 0]},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": 3,
             "type": "VEC2"},
            {"bufferView": 1, "componentType": 5121, "count": 3, "type": "SCALAR"}],
        bufferViews=[{"buffer": 0, "byteOffset": 0, "byteLength": 60, "byteStride": 20},
                     {"buffer": 0, "byteOffset": 60, "byteLength": 3}],
        buffers=[{"byteLength": len(blob), "uri": _data_uri(blob)}])))
    (_, ms), = same_import(p).view(PORT.c.MeshSurface)
    np.testing.assert_allclose(ms.positions, pos)
    np.testing.assert_allclose(ms.uvs, uv)
    np.testing.assert_array_equal(ms.triangles.reshape(-1), [0, 1, 2])


def test_sparse_accessor(tmp_path):
    base = np.zeros((4, 3), np.float32)
    repl = np.array([[9, 9, 9], [7, 7, 7]], np.float32)
    rows = np.array([1, 3], np.uint16)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blob = base.tobytes() + rows.tobytes() + repl.tobytes() + idx.tobytes()
    p = tmp_path / "sparse.gltf"
    p.write_text(json.dumps(_foreign_doc(
        meshes=[{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1}]}],
        accessors=[
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
             "sparse": {"count": 2, "indices": {"bufferView": 1, "componentType": 5123},
                        "values": {"bufferView": 2}}},
            {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"}],
        bufferViews=[{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                     {"buffer": 0, "byteOffset": 48, "byteLength": 4},
                     {"buffer": 0, "byteOffset": 52, "byteLength": 24},
                     {"buffer": 0, "byteOffset": 76, "byteLength": 12}],
        buffers=[{"byteLength": len(blob), "uri": _data_uri(blob)}])))
    (_, ms), = same_import(p).view(PORT.c.MeshSurface)
    expect = base.copy()
    expect[[1, 3]] = repl
    np.testing.assert_allclose(ms.positions, expect)


def test_normalized_u16_uvs(tmp_path):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv16 = np.array([[0, 0], [65535, 0], [0, 32768]], np.uint16)
    blob = pos.tobytes() + uv16.tobytes() + np.array([0, 1, 2], np.uint16).tobytes() + b"\0\0"
    p = tmp_path / "norm.gltf"
    p.write_text(json.dumps(_foreign_doc(
        meshes=[{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                 "indices": 2}]}],
        accessors=[
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3, "type": "VEC2",
             "normalized": True},
            {"bufferView": 2, "componentType": 5123, "count": 3, "type": "SCALAR"}],
        bufferViews=[{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                     {"buffer": 0, "byteOffset": 36, "byteLength": 12},
                     {"buffer": 0, "byteOffset": 48, "byteLength": 6}],
        buffers=[{"byteLength": len(blob), "uri": _data_uri(blob)}])))
    (_, ms), = same_import(p).view(PORT.c.MeshSurface)
    np.testing.assert_allclose(ms.uvs, [[0, 0], [1, 0], [0, 32768 / 65535]], atol=1e-6)


# ---- image decoders: PNG without PIL, the others never silently dropped ----

def _pil_png(mode_case: str) -> bytes:
    """A PNG written by PIL in one of the colour types and depths glTF files carry."""
    from PIL import Image

    yy, xx = np.mgrid[0:37, 0:53]
    rgb = np.stack([xx * 4, yy * 6, (xx + yy) * 2], -1).astype(np.uint8)
    rgb[::7] = np.random.default_rng(1).integers(0, 256, rgb[::7].shape, dtype=np.uint8)
    base = Image.fromarray(rgb)
    kw = {}
    if mode_case == "RGBA":
        a = np.random.default_rng(2).integers(0, 256, rgb.shape[:2] + (1,), dtype=np.uint8)
        im = Image.fromarray(np.concatenate([rgb, a], -1))
    elif mode_case in ("L", "LA", "1", "RGB"):
        im = base.convert(mode_case)
    elif mode_case == "P":
        im = base.convert("P", palette=Image.ADAPTIVE, colors=200)
    elif mode_case == "P4":
        im, kw = base.convert("P", palette=Image.ADAPTIVE, colors=12), {"bits": 4}
    else:  # palette with a transparent index
        im, kw = base.convert("P", palette=Image.ADAPTIVE, colors=30), {"transparency": 3}
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode_case", ["RGB", "RGBA", "L", "LA", "1", "P", "P4", "Ptrns"])
def test_png_decoder_matches_pil_on_every_colour_type(mode_case):
    """render.record.decode_png (zlib only) gives PIL's RGBA for grey, grey-alpha, RGB,
    RGBA and palette PNGs at 1, 4 and 8 bits, tRNS included."""
    from mesheditor_tpu_torch.render.record import decode_png

    data = _pil_png(mode_case)
    np.testing.assert_array_equal(decode_png(data), _pil_rgba(data))


def _adam7_png(rgba: np.ndarray) -> bytes:
    """An interlaced RGBA PNG, every pass's rows filtered with Sub (1)."""
    import zlib

    from mesheditor_tpu_torch.render.record import _ADAM7, _png_chunk

    h, w = rgba.shape[:2]
    raw = b""
    for y0, x0, dy, dx in _ADAM7:
        sub = rgba[y0::dy, x0::dx]
        for row in sub:
            flat = row.reshape(-1).astype(np.int64)
            prev = np.concatenate([np.zeros(4, np.int64), flat[:-4]])
            raw += b"\x01" + ((flat - prev) & 255).astype(np.uint8).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0,
                                                                    0, 1))
            + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


def test_png_decoder_reads_interlaced_files():
    from mesheditor_tpu_torch.render.record import decode_png

    rgba = np.random.default_rng(4).integers(0, 256, (13, 11, 4), dtype=np.uint8)
    data = _adam7_png(rgba)
    np.testing.assert_array_equal(decode_png(data), rgba)
    np.testing.assert_array_equal(_pil_rgba(data), rgba)


def test_jpeg_texture_decodes_as_the_reference_does(tmp_path):
    from PIL import Image

    tex = _checker((200, 60, 40), (40, 60, 200), n=16)
    buf = io.BytesIO()
    Image.fromarray(tex[..., :3]).save(buf, format="JPEG", quality=90)
    doc = _basisu_doc("data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode())
    doc["textures"] = [{"source": 0}]
    p = tmp_path / "jpeg.gltf"
    p.write_text(json.dumps(doc))
    (_, vm), = same_import(p).view(PORT.c.VisualMaterial)
    assert vm.texture.shape == (16, 16, 4) and (vm.texture[..., 3] == 255).all()


@pytest.mark.parametrize("missing,image,needs", [
    ("PIL", "jpeg", "PIL"), ("zstandard", "ktx2", "zstandard")])
def test_a_missing_decoder_raises_and_never_drops_the_texture(tmp_path, monkeypatch, missing,
                                                              image, needs):
    """Without PIL a JPEG texture, and without zstandard a zstd KTX2 texture, stop the
    import with an ImportError that names what is needed; PNG textures need neither."""
    from PIL import Image

    if image == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(_checker((1, 2, 3), (200, 100, 50))[..., :3]).save(buf, format="JPEG")
        uri = "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode()
        doc = _basisu_doc(uri)
        doc["textures"] = [{"source": 0}]
    else:
        blob = _ktx2_bytes(8, 8, _checker((9, 9, 9), (250, 250, 250), n=8), scheme=2)
        doc = _basisu_doc("data:application/ktx2;base64," + base64.b64encode(blob).decode())
    p = tmp_path / "t.gltf"
    p.write_text(json.dumps(doc))
    png_scene = tmp_path / "png.glb"
    PORT.gltf.export_gltf(textured_registry(PORT), png_scene)
    monkeypatch.setitem(sys.modules, missing, None)
    if missing == "PIL":
        monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match=needs):
        PORT.gltf.import_gltf(p)
    (_, vm), = PORT.gltf.import_gltf(png_scene).view(PORT.c.VisualMaterial)
    np.testing.assert_array_equal(vm.texture, _checker((200, 60, 40), (40, 60, 200)))


# ---- tests/test_gltf_visual.py ----

def visual_scene(P):
    c = P.c
    r = P.Registry()
    P.derive.install_default_pipeline(r)
    e = r.create()
    pos, tris = P.mesh.cuboid_surface((0.5, 0.5, 0.5))
    r.emplace(e, c.MeshSurface(positions=pos, triangles=np.asarray(tris, np.uint32)))
    r.emplace(e, c.VisualMaterial(base_color=np.array([0.8, 0.1, 0.2, 1.0]), metallic=0.65,
                                  roughness=0.3, emissive=np.array([0.1, 0.0, 0.05]),
                                  double_sided=False))
    light = r.create()
    r.emplace(light, c.Transform(translation=np.array([0.0, 3.0, 0.0])))
    r.emplace(light, c.LightComponent(kind="spot", color=np.array([1.0, 0.9, 0.8]),
                                      intensity=40.0, range=12.0, inner_cone_angle=0.2,
                                      outer_cone_angle=0.5))
    sun = r.create()
    r.emplace(sun, c.LightComponent(kind="directional", intensity=2.5))
    return r


def test_material_factors_roundtrip(tmp_path):
    mats = list(same_import(same_export(visual_scene, tmp_path, "scene.gltf"))
                .view(PORT.c.VisualMaterial))
    assert len(mats) == 1
    m = mats[0][1]
    assert np.allclose(m.base_color, [0.8, 0.1, 0.2, 1.0])
    assert abs(m.metallic - 0.65) < 1e-12 and abs(m.roughness - 0.3) < 1e-12
    assert np.allclose(m.emissive, [0.1, 0.0, 0.05]) and m.double_sided is False


def test_lights_roundtrip(tmp_path):
    p = same_export(visual_scene, tmp_path, "scene.gltf")
    doc = json.loads(p.read_text())
    assert "KHR_lights_punctual" in doc["extensionsUsed"]
    assert len(doc["extensions"]["KHR_lights_punctual"]["lights"]) == 2
    lights = sorted(same_import(p).view(PORT.c.LightComponent), key=lambda kv: kv[0])
    assert len(lights) == 2
    spot = next(lc for _, lc in lights if lc.kind == "spot")
    assert (spot.intensity, spot.range, spot.inner_cone_angle, spot.outer_cone_angle) == \
        pytest.approx((40.0, 12.0, 0.2, 0.5), abs=1e-12)
    sun = next(lc for _, lc in lights if lc.kind == "directional")
    assert abs(sun.intensity - 2.5) < 1e-12


def test_visual_glb_roundtrip(tmp_path):
    r2 = same_import(same_export(visual_scene, tmp_path, "scene.glb"))
    assert len(list(r2.view(PORT.c.VisualMaterial))) == 1
    assert len(list(r2.view(PORT.c.LightComponent))) == 2


def test_imported_scene_renders(tmp_path):
    r2 = same_import(same_export(visual_scene, tmp_path, "scene.gltf"))
    view = _render(r2, 48, 32)
    img = view.image()
    assert np.isfinite(img).all()
    tri_img = view.gbuf.tri.numpy()
    ys, xs = np.nonzero(tri_img >= 0)
    assert ys.size > 0
    px = img[ys, xs]
    assert px[:, 0].mean() > px[:, 2].mean()  # the imported material is red-dominant


def quad_scene(P):
    r = P.Registry()
    P.derive.install_default_pipeline(r)
    e = r.create()
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float64)
    r.emplace(e, P.c.MeshSurface(positions=pos, triangles=tris, uvs=uvs))
    tex = np.zeros((8, 8, 4), np.uint8)  # left half red, right half blue
    tex[..., 3] = 255
    tex[:, :4, 0] = 255
    tex[:, 4:, 2] = 255
    r.emplace(e, P.c.VisualMaterial(base_color=np.ones(4), metallic=0.0, roughness=1.0,
                                    texture=tex))
    return r


@SUFFIXES
def test_texture_roundtrip_gltf_and_glb(tmp_path, suffix):
    r2 = same_import(same_export(quad_scene, tmp_path, f"scene{suffix}"))
    (_, m), = r2.view(PORT.c.VisualMaterial)
    assert m.texture.shape == (8, 8, 4)
    assert m.texture[0, 0, 0] == 255 and m.texture[0, 7, 2] == 255
    (_, surf), = r2.view(PORT.c.MeshSurface)
    assert surf.uvs.shape == (4, 2)


def test_textured_render_shows_texture_colors(tmp_path):
    from mesheditor_tpu_torch.render import Camera

    r2 = same_import(same_export(quad_scene, tmp_path, "scene.gltf"))
    cam = Camera(eye=np.array([0.0, 0.0, 3.0]), near=0.1, far=20.0)
    img = _render(r2, 64, 64, camera=cam).image()
    left, right = img[32, 16], img[32, 48]
    assert left[0] > left[2] and right[2] > right[0]


def anim_scene(P):
    an = P.anim
    r = P.Registry()
    P.derive.install_default_pipeline(r)
    e = r.create()
    pos, tris = P.mesh.cuboid_surface((0.5, 0.5, 0.5))
    r.emplace(e, P.c.MeshSurface(positions=pos, triangles=np.asarray(tris, np.uint32)))
    r.emplace(e, P.c.Transform())
    rot = np.array([[1.0, 0, 0, 0], [np.cos(0.5), 0, np.sin(0.5), 0]])
    clip = an.AnimationClip("spin", [
        an.AnimationChannel(entity=e, path=an.TargetPath.TRANSLATION,
                            times=np.array([0.0, 1.0]),
                            values=np.array([[0.0, 0, 0], [2.0, 1.0, 0]]),
                            interpolation=an.Interpolation.LINEAR),
        an.AnimationChannel(entity=e, path=an.TargetPath.ROTATION, times=np.array([0.0, 1.0]),
                            values=rot, interpolation=an.Interpolation.LINEAR)])
    holder = r.create()
    r.emplace(holder, an.AnimationClipComponent(clip=clip))
    return r


def test_animation_roundtrip_and_playback(tmp_path):
    an = PORT.anim
    r2 = same_import(same_export(anim_scene, tmp_path, "anim.gltf"))
    clips = [c.clip for _, c in r2.view(an.AnimationClipComponent)]
    assert len(clips) == 1 and clips[0].name == "spin"
    assert {ch.path for ch in clips[0].channels} == {an.TargetPath.TRANSLATION,
                                                     an.TargetPath.ROTATION}
    an.evaluate_clip(r2, clips[0], 0.5)
    t = r2.get(clips[0].channels[0].entity, PORT.c.Transform)
    assert np.allclose(t.translation, [1.0, 0.5, 0.0], atol=1e-6)
    w, x, y, z = t.rotation
    assert abs(x) < 1e-6 and abs(z) < 1e-6 and y > 0.01
    with pytest.raises(TypeError):  # in both packages: an AnimationClip is not JSON
        PORT.snap.snapshot_scene(r2)


def test_cubicspline_and_weights_roundtrip(tmp_path):
    k = 3
    cubic = np.zeros((k, 3, 3))
    cubic[:, 1] = np.linspace(0, 1, k)[:, None] * np.array([1.0, 0, 0])
    weights_vals = np.array([[0.0, 0.0], [1.0, 0.5], [0.0, 1.0]])

    def build(P):
        an = P.anim
        r = P.Registry()
        e = r.create()
        pos, tris = P.mesh.cuboid_surface((0.5, 0.5, 0.5))
        targets = np.zeros((2, pos.shape[0], 3))
        targets[0, :, 1] = 0.1
        r.emplace(e, P.c.MeshSurface(positions=pos, triangles=np.asarray(tris, np.uint32),
                                     morph_targets=targets, morph_weights=np.zeros(2)))
        clip = an.AnimationClip("c", [
            an.AnimationChannel(entity=e, path=an.TargetPath.SCALE, times=np.linspace(0, 1, k),
                                values=cubic, interpolation=an.Interpolation.CUBICSPLINE),
            an.AnimationChannel(entity=e, path=an.TargetPath.WEIGHTS,
                                times=np.linspace(0, 1, k), values=weights_vals,
                                interpolation=an.Interpolation.LINEAR)])
        h = r.create()
        r.emplace(h, an.AnimationClipComponent(clip=clip))
        return r

    r2 = same_import(same_export(build, tmp_path, "anim2.glb"))
    (_, comp), = r2.view(PORT.anim.AnimationClipComponent)
    by_path = {ch.path: ch for ch in comp.clip.channels}
    sc = by_path[PORT.anim.TargetPath.SCALE]
    assert sc.interpolation == PORT.anim.Interpolation.CUBICSPLINE
    assert sc.values.shape == (k, 3, 3) and np.allclose(sc.values, cubic, atol=1e-6)
    wc = by_path[PORT.anim.TargetPath.WEIGHTS]
    assert wc.values.shape == (k, 2) and np.allclose(wc.values, weights_vals, atol=1e-6)
