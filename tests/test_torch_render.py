"""The port's render layer (mesheditor_tpu_torch/render) against the JAX package's, on the
CPU: the rasterizer's G-buffer, deferred shading, the IBL prefilter, flatten_scene and
picking, on the same seeded or seed-free inputs.

Two valid float orders of the rasterizer may resolve a near-tie in depth differently:
XLA's fused program contracts multiply-adds into FMAs, the port's eager ops round every
product. Held to the JAX function run op by op (`jax.disable_jit`), the port's G-buffer is
bit-identical. Held to the jitted program, triangle ids agree except on contested pixels:
both triangles cover the pixel center (float64 barycentrics) and their float64 depths
there agree within 1e-4 relative. Such pixels are rare (28 of 153,600 pixels of a
480x320 torus, 11 of an icosphere(4), on the CPU) and never background against a
triangle. Shading is held to JAX's image fed the same G-buffer, so it is tested apart from
coverage."""

import numpy as np
import pytest
import torch

import mesheditor_tpu  # noqa: F401  (enables x64, as the JAX package's users run it)
import jax
from mesheditor_tpu.mesh import icosphere_surface, torus_surface, uv_sphere_surface
from mesheditor_tpu.render import environment as jenv
from mesheditor_tpu.render import raster as jraster
from mesheditor_tpu.render import scene_render as jscene
from mesheditor_tpu.render.camera import Camera as RefCamera
from mesheditor_tpu.render.picking import box_select_vertices as ref_box_select_vertices
from mesheditor_tpu.scene import components as rc
from mesheditor_tpu.scene.derive import install_default_pipeline as ref_pipeline
from mesheditor_tpu.scene.registry import Registry as RefRegistry

from mesheditor_tpu_torch import convert
from mesheditor_tpu_torch import render as prender
from mesheditor_tpu_torch.render import environment as penv
from mesheditor_tpu_torch.render import raster as praster
from mesheditor_tpu_torch.render import scene_render as pscene
from mesheditor_tpu_torch.render.camera import Camera, frame_points, view_projection
from mesheditor_tpu_torch.scene.derive import install_default_pipeline

SHADE_TOL = 1e-5  # absolute, on [0, 1] colour
BARY_TOL = 1e-5
# XLA's fused depth differs from the same function run op by op by up to 1.3e-4 relative
# on the CPU (icosphere(3) at 240x160; 5.8e-5 on icosphere(4) and 4.1e-5 on a torus at
# 480x320), where the port's depth stays within DEPTH_EXACT_RTOL of the float64 depth.
JIT_DEPTH_RTOL = 5e-4
DEPTH_EXACT_RTOL = 2e-6
TIE_RTOL = 1e-4  # contested: float64 depths of the two triangles within this, relative
CONTESTED_SHARE = 5e-4  # of the image's pixels (measured at most 1.8e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _screen(clip, width, height):
    v = np.asarray(clip, np.float64)
    ndc = v[:, :3] / v[:, 3:4]
    return (ndc[:, 0] + 1) * 0.5 * width, (1 - ndc[:, 1]) * 0.5 * height, ndc[:, 2]


def _bary_depth(clip, tri_v, width, height, y, x):
    """float64 barycentrics and NDC depth of pixel (y, x)'s center in one triangle."""
    sx, sy, nz = (a[tri_v] for a in _screen(clip, width, height))
    px, py = x + 0.5, y + 0.5

    def edge(a, b):
        return (sx[b] - sx[a]) * (py - sy[a]) - (sy[b] - sy[a]) * (px - sx[a])

    area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
    b = np.array([edge(1, 2), edge(2, 0), edge(0, 1)]) / area
    return b, float(b @ nz)


def assert_gbuffers_agree(port, ref, clip, tris, width, height):
    """Port G-buffer vs the jitted JAX G-buffer: ids equal except contested pixels; depth
    and barycentrics close where the ids agree. Returns the contested count."""
    tri, rtri = port.tri.numpy(), np.asarray(ref.tri)
    assert ((tri < 0) == (rtri < 0)).all(), "background against a triangle"
    tris = np.asarray(tris).reshape(-1, 3)
    differ = np.argwhere(tri != rtri)
    for y, x in differ:
        ba, za = _bary_depth(clip, tris[tri[y, x]], width, height, y, x)
        bb, zb = _bary_depth(clip, tris[rtri[y, x]], width, height, y, x)
        assert ba.min() >= -1e-6 and bb.min() >= -1e-6, (y, x, ba, bb)
        assert abs(za - zb) <= TIE_RTOL * abs(zb), (y, x, za, zb)
    assert len(differ) <= CONTESTED_SHARE * tri.size, len(differ)
    same = (tri == rtri) & (tri >= 0)
    depth, rdepth = port.depth.numpy()[same], np.asarray(ref.depth)[same]
    assert np.abs(depth - rdepth).max() <= JIT_DEPTH_RTOL * np.abs(rdepth).max()
    np.testing.assert_array_equal(port.depth.numpy()[tri < 0], np.asarray(ref.depth)[tri < 0])
    assert np.abs(port.bary.numpy()[same] - np.asarray(ref.bary)[same]).max() <= BARY_TOL
    return len(differ)


def assert_depth_exact(gbuf, clip, tris, width, height):
    """Every covered pixel's depth against the float64 depth of its triangle there."""
    ys, xs = np.nonzero(gbuf.tri.numpy() >= 0)
    v = np.asarray(tris).reshape(-1, 3)[gbuf.tri.numpy()[ys, xs]]  # (P, 3) vertex ids
    sx, sy, nz = (a[v] for a in _screen(clip, width, height))
    px, py = xs[:, None] + 0.5, ys[:, None] + 0.5
    a, b = [1, 2, 0], [2, 0, 1]
    e = (sx[:, b] - sx[:, a]) * (py - sy[:, a]) - (sy[:, b] - sy[:, a]) * (px - sx[:, a])
    area = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
            - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0]))
    z64 = (e / area[:, None] * nz).sum(1)
    depth = gbuf.depth.numpy()[ys, xs]
    assert np.abs(depth - z64).max() <= DEPTH_EXACT_RTOL * np.abs(z64).max()


def _clip_of(pts, width, height, **cam):
    mvp = view_projection(frame_points(pts, **cam), width, height)
    return praster.project_points(mvp, pts, device="cpu").numpy(), mvp


# ---------------------------------------------------------------- G-buffer


def test_project_points_bit_equal():
    rng = np.random.default_rng(20261016)
    pts = rng.normal(size=(4096, 3)).astype(np.float32)
    mvp = rng.normal(size=(4, 4))
    got = praster.project_points(mvp, pts, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (4096, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jraster.project_points(mvp, pts)))


@pytest.mark.parametrize("cull_back", [False, True])
def test_gbuffer_bit_identical_to_the_op_by_op_reference(cull_back):
    pts, tris = torus_surface(0.5, 0.2, 16, 8)
    pts = np.asarray(pts, np.float32)
    clip, _ = _clip_of(pts, 96, 64, azimuth_deg=-40.0)
    with jax.disable_jit():
        ref = jraster.rasterize(clip, tris, 96, 64, chunk=64, cull_back=cull_back)
    got = praster.rasterize(clip, tris, 96, 64, chunk=64, cull_back=cull_back, device="cpu")
    for name, a, b in zip(got._fields, got, ref):
        assert a.dtype == {"depth": torch.float32, "tri": torch.int32,
                           "bary": torch.float32}[name]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert (got.tri >= 0).sum() > 400


@pytest.mark.parametrize("mesh", ["torus", "icosphere"])
def test_gbuffer_matches_jitted_reference(mesh):
    pts, tris = torus_surface(0.5, 0.2, 40, 20) if mesh == "torus" else icosphere_surface(3)
    pts = np.asarray(pts, np.float32)
    clip, _ = _clip_of(pts, 240, 160)
    ref = jraster.rasterize(clip, tris, 240, 160, chunk=8)
    got = praster.rasterize(clip, tris, 240, 160, chunk=8, device="cpu")
    assert_gbuffers_agree(got, ref, clip, tris, 240, 160)
    assert (got.tri >= 0).sum() > 3000
    assert_depth_exact(got, clip, tris, 240, 160)


def test_gbuffer_does_not_depend_on_chunk():
    pts, tris = icosphere_surface(2)
    pts = np.asarray(pts, np.float32)
    clip, _ = _clip_of(pts, 80, 60)
    a = praster.rasterize(clip, tris, 80, 60, chunk=8, device="cpu")
    b = praster.rasterize(clip, tris, 80, 60, chunk=64, device="cpu")
    c = praster.rasterize(clip, tris[:-5], 80, 60, chunk=7, device="cpu")  # padded tail
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    d = praster.rasterize(clip, tris[:-5], 80, 60, chunk=8, device="cpu")
    for x, y in zip(c, d):
        assert torch.equal(x, y)


def test_derived_chunk_follows_the_frame():
    """The chunk is sized to the frame under a budget in bytes: a power of two, at least
    1, at most 256. Half of the ~75 GiB an 80 GB card has free keeps 256 at 1920x1440;
    the CPU's 4 GiB takes a smaller chunk for 4K at supersample 2 (7680x4320)."""
    card = (75 << 30) // 2
    assert praster.derive_chunk(1440, 1920, card) == 256
    assert praster.derive_chunk(4320, 7680, praster.CPU_BUDGET_BYTES) == 4
    assert praster.derive_chunk(1440, 1920, praster.CPU_BUDGET_BYTES) == 64
    assert praster.derive_chunk(4320, 7680, 1) == 1
    for budget in (1, 10 ** 6, 3 * 10 ** 8, 10 ** 9, 10 ** 12):
        chunk = praster.derive_chunk(720, 960, budget)
        assert chunk & (chunk - 1) == 0 and 1 <= chunk <= 256
        assert chunk == 1 or praster.BYTES_PER_PAIR * 720 * 960 * chunk <= budget
    assert praster.frame_chunk(None, 4320, 7680, "cpu") == 4
    assert praster.frame_chunk(8, 4320, 7680, "cpu") == 8  # an explicit chunk is honoured
    assert pscene.RenderSettings().chunk is None
    assert praster.raster_peak_bytes(1440, 1920, 256) == 1440 * 1920 * (20 + 21 * 256)


def test_gbuffer_at_the_derived_chunk_equals_chunk_8():
    """A scene rendered at the derived chunk (256 here) and at chunk 8: the G-buffer bit
    for bit, and so the image."""
    pts, tris = icosphere_surface(2)
    settings = pscene.RenderSettings(width=80, height=60)
    derived = pscene.render_mesh(pts, tris, settings=settings, device="cpu")
    settings.chunk = 8
    fixed = pscene.render_mesh(pts, tris, settings=settings, device="cpu")
    np.testing.assert_array_equal(derived, fixed)
    from mesheditor_tpu_torch.scene import components as pc
    from mesheditor_tpu_torch.scene.registry import Registry

    port = Registry()
    install_default_pipeline(port)
    port.emplace(port.create(), pc.MeshSurface(positions=np.asarray(pts),
                                               triangles=np.asarray(tris)))
    views = [pscene.render_scene(port, settings=pscene.RenderSettings(80, 60, chunk=chunk),
                                 device="cpu") for chunk in (None, 8)]
    assert praster.frame_chunk(None, 60, 80, "cpu") == 256
    for a, b in zip(views[0].gbuf, views[1].gbuf):
        assert torch.equal(a, b)


def test_empty_and_degenerate_inputs():
    got = praster.rasterize(np.zeros((0, 4)), np.zeros((0, 3)), 8, 4, device="cpu")
    ref = jraster.rasterize(np.zeros((0, 4)), np.zeros((0, 3)), 8, 4)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got.tri == -1).all() and torch.isinf(got.depth).all()


def test_clip_near_exact():
    """A camera inside a torus: crossers fan out, behind triangles drop."""
    pts, tris = torus_surface(0.5, 0.2, 24, 12)
    cam = Camera(eye=np.array([0.5, 0.0, 0.05]), target=np.array([0.5, 0.0, 1.0]),
                 near=0.01, far=10.0)
    clip = praster.project_points(view_projection(cam, 64, 48), pts, device="cpu").numpy()
    got = praster.clip_near(clip, tris)
    ref = jraster.clip_near(clip, tris)
    assert got[2].shape[0] > 0  # new vertices were cut
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(praster.screen_coords(clip, 64, 48),
                                  jraster.screen_coords(clip, 64, 48))


# ---------------------------------------------------------------- scenes


def carry(ref):
    reg = convert.registry({e: [ref.get(e, t) for t in ref.component_types() if ref.has(e, t)]
                            for e in ref.entities()})
    install_default_pipeline(reg)
    return reg


def _add(r, pts, tris, pos=(0, 0, 0), uvs=None, **mat):
    e = r.create()
    r.emplace(e, rc.Transform(translation=np.asarray(pos, np.float64)))
    surf = rc.MeshSurface(positions=np.asarray(pts, np.float64),
                          triangles=np.asarray(tris, np.uint32))
    if uvs is not None:
        surf.uvs = np.asarray(uvs, np.float32)
    r.emplace(e, surf)
    r.emplace(e, rc.VisualMaterial(**mat))
    return e


def _light(r, kind, pos=(0.0, 0.0, 0.0), rot=(1.0, 0.0, 0.0, 0.0), **kw):
    e = r.create()
    t = rc.Transform(translation=np.asarray(pos, np.float64))
    t.rotation = np.asarray(rot, np.float64)
    r.emplace(e, t)
    r.emplace(e, rc.LightComponent(kind=kind, **kw))
    return e


def _sphere_uvs(pts):
    p = np.asarray(pts, np.float64)
    p = p / np.linalg.norm(p, axis=1, keepdims=True)
    return np.stack([0.5 + np.arctan2(p[:, 0], p[:, 2]) / (2 * np.pi),
                     0.5 - np.arcsin(np.clip(p[:, 1], -1, 1)) / np.pi], 1)


def _texture(rng, h=16, w=24):
    tex = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    tex[..., 3] = 255
    return tex


def scene(kind):
    """Seeded scenes for the shading cases: (reference registry, camera)."""
    rng = np.random.default_rng(20261016)
    r = RefRegistry()
    ref_pipeline(r)
    tpts, ttris = torus_surface(0.5, 0.2, 24, 12)
    spts, stris = uv_sphere_surface(0.45, 10, 20)
    suv = _sphere_uvs(spts)
    if kind == "plain":
        _add(r, tpts, ttris, pos=(-0.6, 0, 0), base_color=np.array([0.8, 0.3, 0.2, 1.0]),
             metallic=0.6, roughness=0.3)
        _add(r, spts, stris, pos=(0.7, 0, 0))
        _light(r, "directional", rot=(0.92, -0.38, 0.0, 0.0), intensity=2.0)
        _light(r, "point", pos=(0.0, 1.5, 1.0), intensity=6.0)
        _light(r, "spot", pos=(0.7, 1.5, 0.5), rot=(0.8, -0.6, 0.0, 0.0), intensity=20.0,
               inner_cone_angle=0.2, outer_cone_angle=0.5)
    elif kind == "textured":
        _add(r, spts, stris, uvs=suv, texture=_texture(rng))
        _add(r, tpts, ttris, pos=(1.0, 0, 0))  # untextured beside a textured object
        _light(r, "directional", intensity=2.0)
    elif kind == "maps":
        nrm = _texture(rng)
        nrm[..., 2] = np.maximum(nrm[..., 2], 200)  # normals pointing mostly out
        _add(r, spts, stris, uvs=suv, texture=_texture(rng), mr_texture=_texture(rng),
             emissive_texture=_texture(rng), normal_texture=nrm,
             occlusion_texture=_texture(rng), emissive=np.array([0.3, 0.2, 0.1]),
             uv_transform=np.array([0.1, -0.2, 0.4, 1.5, 0.8]))
        _light(r, "point", pos=(0.5, 1.0, 1.5), intensity=8.0)
    elif kind in ("extensions", "transmission", "ibl"):
        _add(r, tpts, ttris, pos=(-0.7, 0, 0), clearcoat=0.8, clearcoat_roughness=0.2,
             sheen_color=np.array([0.6, 0.2, 0.9]), sheen_roughness=0.5, ior=1.8,
             specular=0.7, specular_color=np.array([1.0, 0.8, 0.6]), metallic=0.1)
        _add(r, spts, stris, pos=(0.7, 0, 0),
             transmission=0.7 if kind != "extensions" else 0.0,
             unlit=kind == "extensions", roughness=0.35)
        _add(r, spts * 0.5, stris, pos=(0, 0.6, 0), roughness=0.05, metallic=1.0)
        _light(r, "directional", rot=(0.92, -0.38, 0.0, 0.0), intensity=1.5)
    cam = RefCamera(eye=np.array([0.3, 0.9, 3.0]), target=np.zeros(3), near=0.1, far=20.0)
    return r, cam


def _env(seed=7, h=24):
    rng = np.random.default_rng(seed)
    env = rng.uniform(0.0, 2.0, (h, 2 * h, 3)).astype(np.float32)
    env[2:5, 6:10] = (30.0, 28.0, 22.0)  # a sun blob
    return env


def _port_env(ref_env):
    return penv.PrefilteredEnv(torch.as_tensor(np.array(ref_env.specular)),
                               torch.as_tensor(np.array(ref_env.diffuse)), ref_env.levels)


def _port_camera(cam):
    return Camera(eye=cam.eye, target=cam.target, up=cam.up, fov_y=cam.fov_y, near=cam.near,
                  far=cam.far)


SHADE_CASES = {  # case: (scene, RenderSettings fields)
    "smooth": ("plain", dict(sky=(0.3, 0.4, 0.5), ground=(0.2, 0.15, 0.1))),
    "flat": ("plain", dict(mode="flat")),
    "wireframe": ("plain", dict(mode="wireframe")),
    "wireframe_only": ("plain", dict(mode="wireframe_only")),
    "textured": ("textured", {}),
    "normal_mapped": ("maps", {}),
    "extensions": ("extensions", {}),
    "transmission": ("transmission", dict(background=(0.3, 0.5, 0.2))),
    "ibl": ("ibl", dict(ambient=(0.0, 0.0, 0.0))),
}


@pytest.mark.parametrize("case", sorted(SHADE_CASES))
def test_shade_matches_reference_on_its_gbuffer(case):
    kind, fields = SHADE_CASES[case]
    ref, cam = scene(kind)
    reg = carry(ref)
    rset = jscene.RenderSettings(width=96, height=72, **fields)
    if case == "ibl":
        rset.environment = _env()
    jv = jscene.render_scene(ref, camera=cam, settings=rset)
    expect = np.asarray(jv.image())
    # The port's own flatten of the carried scene: the same soup, rows and light bank.
    reg.process()
    batch = pscene.flatten_scene(reg, device="cpu")
    np.testing.assert_array_equal(pscene.world_points(reg), batch.positions)
    jb = jv.batch
    for f in ("positions", "normals", "triangles", "tri_obj", "uvs", "tangents"):
        a, b = getattr(batch, f), getattr(jb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert batch.entities == jb.entities
    for table in ("materials", "lights"):
        for f, a in getattr(batch, table)._asdict().items():
            b = getattr(getattr(jb, table), f)
            assert (a is None) == (b is None), (table, f)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for f in ("atlas", "mr_atlas", "emissive_atlas", "normal_atlas", "occlusion_atlas"):
        a, b = getattr(batch, f), getattr(jb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)
    env = None
    if case == "ibl":
        env = _port_env(jscene._resolve_environment(rset.environment))
    gbuf = praster.GBuffer(*(torch.as_tensor(np.array(a)) for a in jv.gbuf))
    got = prender.shade(
        gbuf, jv._positions, jv._normals, jv._tris, jv._tri_obj, batch.materials,
        batch.lights, eye=np.asarray(cam.eye, np.float32), ambient=rset.ambient,
        background=rset.background, flat=rset.mode == "flat",
        wireframe=rset.mode == "wireframe", wire_only=rset.mode == "wireframe_only",
        uvs=jv._uvs, atlas=batch.atlas, sky=rset.sky, ground=rset.ground,
        mr_atlas=batch.mr_atlas, emissive_atlas=batch.emissive_atlas,
        normal_atlas=batch.normal_atlas, occlusion_atlas=batch.occlusion_atlas,
        tangents=jv._tangents, environment=env)
    assert got.dtype == torch.float32 and got.shape == expect.shape == (72, 96, 3)
    assert np.abs(got.numpy() - expect).max() <= SHADE_TOL
    assert (np.asarray(jv.gbuf.tri) >= 0).mean() > 0.04  # the objects are in the frame
    if case in ("extensions", "transmission", "ibl"):
        assert batch.materials.ext is not None
    else:
        assert batch.materials.ext is None  # the legacy path the goldens hold


@pytest.mark.parametrize("source", ["float", "uint8"])
def test_prefilter_environment_matches_reference(source):
    env = _env(seed=11, h=32)
    if source == "uint8":
        env = (np.clip(env / 4.0, 0, 1) * 255).astype(np.uint8)
    ref = jenv.prefilter_environment(env, levels=4, base_height=16, samples=48)
    got = penv.prefilter_environment(env, levels=4, base_height=16, samples=48, device="cpu")
    assert got.levels == ref.levels == 4
    for a, b in ((got.specular, ref.specular), (got.diffuse, ref.diffuse)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6 * np.abs(b).max())


def test_environment_host_helpers_are_copies():
    env = _env(seed=3, h=16)
    q = (0.9, 0.1, 0.3, 0.2)
    np.testing.assert_array_equal(penv.cube_faces_from_equirect(env, 8, rotation=q),
                                  jenv.cube_faces_from_equirect(env, 8, rotation=q))
    faces = jenv.cube_faces_from_equirect(env, 8)
    np.testing.assert_array_equal(penv.equirect_from_cube_faces(faces, 12, rotation=q),
                                  jenv.equirect_from_cube_faces(faces, 12, rotation=q))
    sh = penv.sh9_irradiance_coefficients(env)
    np.testing.assert_array_equal(sh, jenv.sh9_irradiance_coefficients(env))
    np.testing.assert_array_equal(penv.equirect_from_sh9(sh), jenv.equirect_from_sh9(sh))


def test_scene_ibl_component_becomes_the_environment():
    ref, cam = scene("ibl")
    e = ref.create()
    ref.emplace(e, rc.ImageBasedLightComponent(equirect=_env(seed=5, h=16), intensity=1.5,
                                               rotation=np.array([0.96, 0.0, 0.28, 0.0])))
    reg = carry(ref)
    rset = jscene.RenderSettings(width=64, height=48)
    expect = np.asarray(jscene.render_scene(ref, camera=cam, settings=rset).image())
    got = pscene.render_scene(reg, camera=_port_camera(cam), settings=pscene.RenderSettings(
        width=64, height=48), device="cpu").image()
    # Coverage and prefilter both run in each package here: the image agrees except where
    # a contested pixel picked the other triangle.
    diff = np.abs(got - expect).max(-1)
    assert (diff > 1e-4).mean() < 2e-3 and np.median(diff) < 1e-6


# ---------------------------------------------------------------- picking


def _pick_scene():
    ref, cam = scene("plain")
    jv = jscene.render_scene(ref, camera=cam, settings=jscene.RenderSettings(96, 72))
    pv = pscene.render_scene(carry(ref), camera=_port_camera(cam),
                             settings=pscene.RenderSettings(96, 72), device="cpu")
    return jv, pv


def test_picking_matches_reference():
    jv, pv = _pick_scene()
    tri, rtri = pv.gbuf.tri.numpy(), np.asarray(jv.gbuf.tri)
    pixels = [(x, y) for y in range(2, 72, 5) for x in range(3, 96, 5) if tri[y, x] == rtri[y, x]]
    assert len(pixels) > 200 and sum(tri[y, x] >= 0 for x, y in pixels) > 40
    for x, y in pixels:
        assert pv.pick_entity(x, y) == jv.pick_entity(x, y), (x, y)
        for kind in ("face", "vertex", "edge"):
            assert pv.pick_element(x, y, kind) == jv.pick_element(x, y, kind), (x, y, kind)
    with pytest.raises(ValueError, match="unknown element kind"):
        prender.pick_element(pv.gbuf, pv._tris, *next((x, y) for x, y in pixels
                                                      if tri[y, x] >= 0), "corner")
    for rect in ((0, 0, 95, 71), (0, 0, 47, 71), (60, 10, 90, 60), (40, 0, 44, 3)):
        assert pv.box_select_entities(*rect) == jv.box_select_entities(*rect), rect
        np.testing.assert_array_equal(
            prender.box_select_vertices(pv.clip, 96, 72, *rect, gbuf=pv.gbuf, tris=pv._tris),
            ref_box_select_vertices(jv.clip, 96, 72, *rect, gbuf=jv.gbuf, tris=jv._tris))
        np.testing.assert_array_equal(prender.box_select_vertices(pv.clip, 96, 72, *rect),
                                      ref_box_select_vertices(jv.clip, 96, 72, *rect))


def test_camera_inside_the_scene_matches_reference():
    """Near-plane crossers are clipped into fans whose new vertices lerp every attribute;
    element picks snap back to source triangles and original vertices."""
    ref, _cam = scene("plain")
    cam = dict(eye=np.array([-0.1, 0.0, 0.05]), target=np.array([-1.0, 0.0, -0.3]),
               near=0.05, far=20.0)
    jv = jscene.render_scene(ref, camera=RefCamera(**cam),
                             settings=jscene.RenderSettings(64, 48))
    pv = pscene.render_scene(carry(ref), camera=Camera(**cam),
                             settings=pscene.RenderSettings(64, 48), device="cpu")
    assert pv.clip.shape[0] > pv.batch.positions.shape[0]  # vertices were cut
    np.testing.assert_array_equal(pv._tris, jv._tris)
    np.testing.assert_array_equal(pv._tri_src, jv._tri_src)
    np.testing.assert_array_equal(pv.clip, np.asarray(jv.clip))
    diff = np.abs(pv.image() - np.asarray(jv.image())).max(-1)
    assert np.median(diff) < 1e-6 and (diff > 1e-4).mean() < 2e-3
    tri, rtri = pv.gbuf.tri.numpy(), np.asarray(jv.gbuf.tri)
    hits = [(x, y) for y in range(1, 48, 4) for x in range(1, 64, 4)
            if tri[y, x] == rtri[y, x] >= 0]
    assert len(hits) > 20
    for x, y in hits:
        for kind in ("face", "vertex", "edge"):
            assert pv.pick_element(x, y, kind) == jv.pick_element(x, y, kind), (x, y, kind)


def test_box_select_reduces_on_the_device():
    _jv, pv = _pick_scene()
    rows = prender.box_select(pv.gbuf, torch.as_tensor(pv._tri_obj), 0, 0, 95, 71)
    assert isinstance(rows, np.ndarray) and rows.tolist() == [0, 1]
    assert prender.box_select(pv.gbuf, pv._tri_obj, 0, 0, 1, 1).size == 0


def test_supersampled_scene_and_mesh_match_reference():
    ref, cam = scene("plain")
    rset = dict(width=48, height=36, supersample=2)
    expect = np.asarray(jscene.render_scene(ref, camera=cam,
                                            settings=jscene.RenderSettings(**rset)).image())
    got = pscene.render_scene(carry(ref), camera=_port_camera(cam),
                              settings=pscene.RenderSettings(**rset), device="cpu").image()
    assert got.shape == expect.shape == (36, 48, 3) and got.dtype == np.float32
    diff = np.abs(got - expect).max(-1)
    assert np.median(diff) < 1e-6 and (diff > 1e-4).sum() <= 3
    pts, tris = icosphere_surface(2)
    vals = np.asarray(pts)[:, 1]
    for kw in (dict(vertex_values=vals), {}):
        expect = np.asarray(jscene.render_mesh(pts, tris, settings=jscene.RenderSettings(
            40, 30, supersample=2), **kw))
        got = pscene.render_mesh(pts, tris, settings=pscene.RenderSettings(
            40, 30, supersample=2), device="cpu", **kw)
        assert got.dtype == expect.dtype and got.shape == expect.shape
        assert np.median(np.abs(got - expect)) < 1e-6 and np.abs(got - expect).max() < 0.05


def test_viridis_matches_reference():
    x = np.linspace(-0.2, 1.2, 301)
    np.testing.assert_array_equal(pscene._viridis(torch.as_tensor(x)).numpy(),
                                  jscene._viridis(x))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be observed")
    pts, tris = icosphere_surface(1)
    ref, _cam = scene("plain")
    reg = carry(ref)
    calls = [
        lambda: prender.rasterize(np.zeros((3, 4)), [[0, 1, 2]], 4, 4),
        lambda: prender.render_mesh(pts, tris),
        lambda: prender.render_scene(reg),
        lambda: pscene.flatten_scene(reg),
        lambda: penv.prefilter_environment(_env()),
        lambda: praster.project_points(np.eye(4), pts),
        lambda: prender.MaterialTable.default(1),
        lambda: prender.LightBank.default(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
