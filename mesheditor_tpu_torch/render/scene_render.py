"""Scene-level rendering: ECS registry -> lit image / G-buffer (the SubmitViewport +
ProcessComponentEvents render path, reference src/viewport/Viewport.h:10-32; counterpart
of mesheditor_tpu/render/scene_render.py).

Flattens every MeshSurface under its WorldTransform into one vertex/triangle soup with
per-triangle object ids (the reference's contiguous GPU arenas + instance models,
src/mesh/MeshStore.h:76) on the host, builds the material table from VisualMaterial
components and the light bank from LightComponent entities as tensors on the target
device, and runs the raster + shade passes there. Supersampled rendering (ss=2) stands
in for MSAA; the samples are averaged on the device, so only the final image is copied
to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from .camera import Camera, frame_points, view_projection
from .picking import box_select, pick_element, pick_object
from .raster import GBuffer, clip_near, frame_chunk, project_points, rasterize
from .shading import (
    LightBank, MaterialTable, build_atlas, shade, vertex_normals, vertex_tangents,
)


@dataclass
class RenderSettings:
    width: int = 640
    height: int = 480
    mode: str = "smooth"  # smooth | flat | wireframe (overlay) | wireframe_only
    supersample: int = 1
    background: tuple = (0.125, 0.133, 0.153)
    ambient: tuple = (0.06, 0.06, 0.07)
    # Hemisphere environment light (sky above, ground below); zeros disable.
    sky: tuple = (0.0, 0.0, 0.0)
    ground: tuple = (0.0, 0.0, 0.0)
    # Image-based environment: an equirect radiance map (h, w, 3) uint8 sRGB or float
    # linear, or an already-prefiltered PrefilteredEnv. Prefiltering is cached per
    # source array (the reference prefilters once at load, IblPrefilterPipelines.h).
    environment: object = None
    # Triangles rasterized per step; the G-buffer does not depend on it. None derives it
    # from the frame: the largest power of two up to 256 whose step fits in half the free
    # memory (raster.frame_chunk). At 1920x1440 a step holds ~21 bytes per pixel-triangle
    # pair, 14 GiB at chunk 256, which was the fastest of 8, 64 and 256 there (PERF.md §5).
    chunk: int | None = None


@dataclass
class SceneBatch:
    """Flattened draw soup + the id maps picking needs."""

    positions: np.ndarray   # (N, 3) world
    normals: np.ndarray     # (N, 3) world
    triangles: np.ndarray   # (T, 3)
    tri_obj: np.ndarray     # (T,) row into entities/materials
    entities: list          # object row -> entity id
    materials: MaterialTable
    lights: LightBank
    uvs: np.ndarray = None     # (N, 2) TEXCOORD_0 (zeros where untextured)
    atlas: object = None       # TextureAtlas | None (baseColor, sRGB)
    mr_atlas: object = None        # metallicRoughness (linear ORM)
    emissive_atlas: object = None  # emissive (sRGB)
    normal_atlas: object = None    # tangent-space normals (linear)
    occlusion_atlas: object = None  # occlusion R (linear)
    tangents: np.ndarray = None    # (N, 3) world tangents when normal-mapped

    @property
    def device(self) -> torch.device:
        return self.materials.base_color.device


def _light_world_dir(r, e) -> np.ndarray:
    """Light direction = node world -Z (KHR_lights_punctual convention)."""
    from ..scene.components import WorldTransform

    wt = r.get(e, WorldTransform)
    m = wt.matrix if wt is not None else np.eye(4)
    d = -np.asarray(m)[:3, 2]
    n = np.linalg.norm(d)
    return d / n if n > 1e-12 else np.array([0.0, -1.0, 0.0])


def _visible(r, e, memo) -> bool:
    """Effective KHR_node_visibility: a node is drawn only if itself and every
    ancestor is visible (the extension's inheriting semantics)."""
    from ..scene.components import SceneNode, VisibilityComponent

    seen = set()
    chain = []
    cur = e
    while cur and cur not in seen:
        if cur in memo:
            break
        seen.add(cur)
        chain.append(cur)
        v = r.get(cur, VisibilityComponent)
        if v is not None and not v.visible:
            for c in chain:
                memo[c] = False
            return False
        sn = r.get(cur, SceneNode)
        cur = sn.parent if sn else 0
    base = memo.get(cur, True)
    for c in chain:
        memo[c] = base
    return base


def _drawn_surfaces(r, vis_memo: dict):
    """Each visible mesh entity with geometry, in entity order: (entity, surface, its
    drawn positions (deformed or morphed) in its own frame, triangles, world matrix)."""
    from ..scene.armature import DeformedSurface
    from ..scene.components import MeshSurface, WorldTransform

    for e, surf in sorted(r.view(MeshSurface), key=lambda kv: kv[0]):
        if not _visible(r, e, vis_memo):
            continue
        deformed = r.get(e, DeformedSurface)
        if deformed is not None and deformed.positions.shape[0] == surf.positions.shape[0]:
            p = np.asarray(deformed.positions, np.float64)
        else:
            p = np.asarray(surf.morphed_positions(), np.float64)
        t = np.asarray(surf.triangles, np.int64).reshape(-1, 3)
        if p.shape[0] == 0 or t.shape[0] == 0:
            continue
        wt = r.get(e, WorldTransform)
        yield e, surf, p, t, (np.asarray(wt.matrix) if wt is not None else np.eye(4))


def world_points(r, origin_if_empty: bool = True) -> np.ndarray:
    """The world-space vertices that flatten_scene would draw, as (N, 3) float32 on the
    host with nothing put on a device: what a camera frames. When nothing is drawn, one
    point at the origin, or none with `origin_if_empty=False`. Requires world transforms
    to be derived (r.process())."""
    parts = [p @ m[:3, :3].T + m[:3, 3] for _e, _s, p, _t, m in _drawn_surfaces(r, {})]
    if parts:
        return np.concatenate(parts).astype(np.float32)
    return np.zeros((1 if origin_if_empty else 0, 3), np.float32)


def flatten_scene(r, device="cuda") -> SceneBatch:
    """Registry -> draw batch, its material, light and texture rows on `device`.
    Requires world transforms to be derived (r.process())."""
    from ..scene.components import LightComponent, VisualMaterial, WorldTransform
    from .shading import LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT

    dev = resolve_device(device)
    vis_memo: dict = {}

    pos_parts, nrm_parts, tri_parts, obj_parts, entities = [], [], [], [], []
    base_colors, metallics, roughnesses, emissives, uv_transforms = [], [], [], [], []
    f0_rows, ext_rows, sheen_rows = [], [], []
    uv_parts, tan_parts = [], []
    textures, mr_texs, em_texs, nrm_texs, occ_texs = [], [], [], [], []
    offset = 0

    for e, surf, p, t, m in _drawn_surfaces(r, vis_memo):
        pw = p @ m[:3, :3].T + m[:3, 3]
        # Normals via inverse-transpose so non-uniform scales light correctly.
        nrm_local = vertex_normals(p, t)
        nit = np.linalg.inv(m[:3, :3]).T if abs(np.linalg.det(m[:3, :3])) > 1e-18 else m[:3, :3]
        nw = nrm_local @ nit.T
        nn = np.linalg.norm(nw, axis=1, keepdims=True)
        nw = np.divide(nw, nn, out=np.zeros_like(nw), where=nn > 1e-20)
        row = len(entities)
        pos_parts.append(pw)
        nrm_parts.append(nw)
        tri_parts.append(t + offset)
        obj_parts.append(np.full(t.shape[0], row, np.int32))
        uv = np.asarray(surf.uvs, np.float32)
        uv_parts.append(uv if uv.shape[0] == p.shape[0] else np.zeros((p.shape[0], 2), np.float32))
        entities.append(e)
        offset += p.shape[0]
        mat = r.get(e, VisualMaterial)
        if mat is None:
            mat = VisualMaterial()
        base_colors.append(np.asarray(mat.base_color, np.float32).reshape(4))
        metallics.append(float(mat.metallic))
        roughnesses.append(float(mat.roughness))
        # KHR_materials_emissive_strength folds into the emissive factor here — the
        # shader never sees it separately.
        emissives.append(np.asarray(mat.emissive, np.float32).reshape(3)
                         * np.float32(getattr(mat, "emissive_strength", 1.0)))
        # KHR_materials_{ior,specular,unlit,clearcoat,sheen,transmission} rows.
        ior = float(getattr(mat, "ior", 1.5))
        f0s = ((ior - 1.0) / max(ior + 1.0, 1e-6)) ** 2
        sc = np.asarray(getattr(mat, "specular_color", np.ones(3)), np.float32)
        spec_f = float(getattr(mat, "specular", 1.0))
        f0_rows.append(np.clip(f0s * sc * spec_f, 0.0, 1.0).reshape(3))
        ext_rows.append(np.array([
            1.0 if getattr(mat, "unlit", False) else 0.0,
            float(getattr(mat, "clearcoat", 0.0)),
            float(getattr(mat, "clearcoat_roughness", 0.0)),
            float(getattr(mat, "sheen_roughness", 0.0)),
            float(getattr(mat, "transmission", 0.0)),
            spec_f,
        ], np.float32))
        sheen_rows.append(np.asarray(getattr(mat, "sheen_color", np.zeros(3)),
                                     np.float32).reshape(3))
        tr = np.asarray(getattr(mat, "uv_transform", (0, 0, 0, 1, 1)), np.float32)
        uv_transforms.append(tr.reshape(5) if tr.size == 5 else
                             np.array([0, 0, 0, 1, 1], np.float32))

        def _tex(name):
            t = getattr(mat, name, None)
            t = np.asarray(t) if t is not None else None
            return t if t is not None and t.size else None

        textures.append(_tex("texture"))
        mr_texs.append(_tex("mr_texture"))
        em_texs.append(_tex("emissive_texture"))
        nrm_texs.append(_tex("normal_texture"))
        occ_texs.append(_tex("occlusion_texture"))
        if nrm_texs[-1] is not None and uv_parts[-1].any():
            tan_local = vertex_tangents(p, t, uv_parts[-1])
            tw = tan_local @ m[:3, :3].T
            tn = np.linalg.norm(tw, axis=1, keepdims=True)
            tan_parts.append(np.divide(tw, tn, out=np.zeros_like(tw), where=tn > 1e-20))
        else:
            tan_parts.append(np.zeros((p.shape[0], 3), np.float32))

    kinds, lpos, ldir, lcol, cones = [], [], [], [], []
    kind_map = {"directional": LIGHT_DIRECTIONAL, "point": LIGHT_POINT, "spot": LIGHT_SPOT}
    for e, light in sorted(r.view(LightComponent), key=lambda kv: kv[0]):
        if not _visible(r, e, vis_memo):
            continue
        wt = r.get(e, WorldTransform)
        m = np.asarray(wt.matrix) if wt is not None else np.eye(4)
        kinds.append(kind_map.get(light.kind, LIGHT_DIRECTIONAL))
        lpos.append(m[:3, 3])
        ldir.append(_light_world_dir(r, e))
        lcol.append(np.asarray(light.color, np.float64) * light.intensity)
        cones.append((np.cos(light.outer_cone_angle), np.cos(light.inner_cone_angle)))

    def up(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    if entities:
        positions = np.concatenate(pos_parts).astype(np.float32)
        normals = np.concatenate(nrm_parts).astype(np.float32)
        triangles = np.concatenate(tri_parts).astype(np.int32)
        tri_obj = np.concatenate(obj_parts)
        uvs = np.concatenate(uv_parts).astype(np.float32)
        atlas = build_atlas(textures, device=dev)
        mr_atlas = build_atlas(mr_texs, srgb=False, device=dev)
        emissive_atlas = build_atlas(em_texs, device=dev)
        normal_atlas = build_atlas(nrm_texs, srgb=False, device=dev)
        occlusion_atlas = build_atlas(occ_texs, srgb=False, device=dev)
        tangents = (np.concatenate(tan_parts).astype(np.float32)
                    if normal_atlas is not None else None)
        tr_rows = np.stack(uv_transforms)
        identity_tr = np.allclose(tr_rows, np.array([0, 0, 0, 1, 1], np.float32))
        # Extension rows only when some material departs from the defaults, so plain
        # scenes take the legacy shader (the corpus goldens).
        f0_arr = np.stack(f0_rows)
        ext_arr = np.stack(ext_rows)
        sheen_arr = np.stack(sheen_rows)
        default_ext = (np.allclose(ext_arr, np.array([0, 0, 0, 0, 0, 1], np.float32))
                       and np.allclose(f0_arr, 0.04, atol=1e-6)
                       and not sheen_arr.any())
        materials = MaterialTable(
            base_color=up(np.stack(base_colors)),
            metallic=up(metallics),
            roughness=up(roughnesses),
            emissive=up(np.stack(emissives)),
            uv_transform=None if identity_tr else up(tr_rows),
            f0_color=None if default_ext else up(f0_arr),
            ext=None if default_ext else up(ext_arr),
            sheen_color=None if default_ext else up(sheen_arr),
        )
    else:
        positions = np.zeros((0, 3), np.float32)
        normals = np.zeros((0, 3), np.float32)
        triangles = np.zeros((0, 3), np.int32)
        tri_obj = np.zeros(0, np.int32)
        uvs = np.zeros((0, 2), np.float32)
        atlas = mr_atlas = emissive_atlas = normal_atlas = occlusion_atlas = None
        tangents = None
        materials = MaterialTable.default(1, device=dev)
    lights = (LightBank.from_lists(kinds, lpos, ldir, lcol, cones, device=dev) if kinds
              else LightBank.default(device=dev))
    return SceneBatch(positions, normals, triangles, tri_obj, entities, materials,
                      lights, uvs=uvs, atlas=atlas, mr_atlas=mr_atlas,
                      emissive_atlas=emissive_atlas, normal_atlas=normal_atlas,
                      occlusion_atlas=occlusion_atlas, tangents=tangents)


_ENV_CACHE: dict = {}


def _resolve_environment(env, device):
    """settings.environment -> PrefilteredEnv on `device` (cached per source array
    identity and device)."""
    if env is None:
        return None
    from .environment import PrefilteredEnv, prefilter_environment

    if isinstance(env, PrefilteredEnv):
        return PrefilteredEnv(env.specular.to(device), env.diffuse.to(device), env.levels)
    key = (id(env), str(device))
    if key not in _ENV_CACHE:
        if len(_ENV_CACHE) > 8:
            _ENV_CACHE.clear()
        _ENV_CACHE[key] = prefilter_environment(env, device=device)
    return _ENV_CACHE[key]


class SceneRenderer:
    """A bound (scene batch, camera, settings) render with picking — the Viewport. It
    renders on the batch's device."""

    def __init__(self, batch: SceneBatch, camera: Camera, settings: RenderSettings):
        from .. import profile

        self.batch = batch
        self.camera = camera
        self.settings = settings
        self.device = batch.device
        ss = max(int(settings.supersample), 1)
        self._rw, self._rh = settings.width * ss, settings.height * ss
        mvp = view_projection(camera, settings.width, settings.height)
        clip = project_points(mvp, batch.positions, device=self.device)
        # The host copy serves near-plane clipping and host-side selection math; the
        # rasterizer takes the device copy unless clipping appended vertices.
        self.clip = clip.cpu().numpy()
        # Near-plane crossers are clipped on host into fans of safe triangles; the
        # lerp recipes extend every per-vertex attribute consistently (clip space is
        # linear in world space, so one t serves all).
        self._tris, self._tri_src, new_verts = clip_near(self.clip, batch.triangles)
        self._positions = np.asarray(batch.positions)
        self._normals = np.asarray(batch.normals)
        self._uvs = batch.uvs
        self._tangents = batch.tangents
        if new_verts.shape[0]:
            a = new_verts[:, 0].astype(np.int64)
            b = new_verts[:, 1].astype(np.int64)
            t = new_verts[:, 2][:, None]

            def lerp(arr):
                arr = np.asarray(arr)
                return np.concatenate(
                    [arr, (arr[a] * (1 - t) + arr[b] * t).astype(arr.dtype)])

            def lerp_unit(arr):
                out = lerp(arr)
                nn = np.linalg.norm(out, axis=1, keepdims=True)
                return np.divide(out, nn, out=out, where=nn > 1e-20)

            self.clip = lerp(self.clip)
            clip = self.clip
            self._positions = lerp(self._positions)
            self._normals = lerp_unit(self._normals)
            if self._uvs is not None and len(self._uvs) == len(batch.positions):
                self._uvs = lerp(self._uvs)
            if self._tangents is not None:
                self._tangents = lerp_unit(self._tangents)
        self._tri_obj = (np.asarray(batch.tri_obj)[self._tri_src]
                         if self._tri_src.size else np.zeros(0, np.int32))
        with profile.scope("render/rasterize", sync=self.device):
            chunk = frame_chunk(settings.chunk, self._rh, self._rw, self.device)
            self.gbuf: GBuffer = rasterize(clip, self._tris, self._rw, self._rh,
                                           chunk=chunk, device=self.device)

    def shade_frame(self) -> torch.Tensor:
        """The lit frame at the rasterized (supersampled) size, on the device."""
        s = self.settings
        return shade(
            self.gbuf, self._positions, self._normals,
            self._tris,
            self._tri_obj, self.batch.materials, self.batch.lights,
            eye=np.asarray(self.camera.eye, np.float32),
            ambient=s.ambient, background=s.background,
            flat=s.mode == "flat",
            wireframe=s.mode == "wireframe",
            wire_only=s.mode == "wireframe_only",
            uvs=self._uvs, atlas=self.batch.atlas,
            sky=s.sky, ground=s.ground,
            mr_atlas=self.batch.mr_atlas,
            emissive_atlas=self.batch.emissive_atlas,
            normal_atlas=self.batch.normal_atlas,
            occlusion_atlas=self.batch.occlusion_atlas,
            tangents=self._tangents,
            environment=_resolve_environment(s.environment, self.device),
        )

    def image(self) -> np.ndarray:
        """The lit image at the settings' size on the host: supersamples are averaged on
        the device, then the image is copied once."""
        from .. import profile

        s = self.settings
        if self._tris.size == 0:  # fully hidden/empty scene: background only
            return np.tile(np.asarray(s.background, np.float64),
                           (s.height, s.width, 1))
        with profile.scope("render/shade", sync=self.device):
            img = _downsample(self.shade_frame(), s)
        return img.cpu().numpy()

    def _to_render_px(self, x, y):
        ss = max(int(self.settings.supersample), 1)
        return int(x) * ss, int(y) * ss

    def pick_entity(self, x: int, y: int) -> int:
        """Entity under the pixel; -1 on background (ObjectPick.comp analog)."""
        if self._tris.size == 0:
            return -1
        rx, ry = self._to_render_px(x, y)
        row = pick_object(self.gbuf, self._tri_obj, rx, ry)
        return self.batch.entities[row] if row >= 0 else -1

    def pick_element(self, x: int, y: int, kind: str = "face"):
        """Element picks in SOURCE-triangle space: clipped replacement triangles map
        back through tri_src, and synthesized near-plane vertices snap to the source
        triangle's closest original corner."""
        rx, ry = self._to_render_px(x, y)
        res = pick_element(self.gbuf, self._tris, rx, ry, kind)
        if res is None:
            return None
        if kind == "face":
            return int(self._tri_src[res])
        n_orig = self.batch.positions.shape[0]

        def snap(vid):
            if vid < n_orig:
                return int(vid)
            tri = int(self.gbuf.tri[ry, rx].item())
            src = np.asarray(self.batch.triangles).reshape(-1, 3)[self._tri_src[tri]]
            d = ((self._positions[src] - self._positions[vid]) ** 2).sum(1)
            return int(src[int(np.argmin(d))])

        if kind == "vertex":
            return snap(res)
        a, b = (snap(v) for v in res)
        return (min(a, b), max(a, b))

    def entity_mask(self, entity: int) -> np.ndarray:
        """(height, width) bool on the host: the pixels whose front triangle (in any of
        their supersamples) belongs to `entity`, from one copy of the triangle-id buffer.
        Clipped triangles map to their source object through _tri_obj."""
        s = self.settings
        rows = [i for i, e in enumerate(self.batch.entities) if e == entity]
        if not rows or self._tris.size == 0:
            return np.zeros((s.height, s.width), bool)
        tri = self.gbuf.tri.cpu().numpy()
        hit = tri >= 0
        mask = np.zeros(tri.shape, bool)
        mask[hit] = self._tri_obj[tri[hit]] == rows[0]
        ss = max(int(s.supersample), 1)
        if ss > 1:
            mask = mask.reshape(s.height, ss, s.width, ss).any(axis=(1, 3))
        return mask

    def box_select_entities(self, x0, y0, x1, y1) -> list:
        ss = max(int(self.settings.supersample), 1)
        rows = box_select(self.gbuf, self._tri_obj, x0 * ss, y0 * ss,
                          x1 * ss, y1 * ss)
        return [self.batch.entities[int(i)] for i in rows]


def _downsample(img: torch.Tensor, settings: RenderSettings) -> torch.Tensor:
    """Average ss x ss supersamples on the device."""
    ss = max(int(settings.supersample), 1)
    if ss == 1:
        return img
    return img.reshape(settings.height, ss, settings.width, ss, img.shape[-1]).mean(dim=(1, 3))


def render_scene(r, camera: Camera | None = None,
                 settings: RenderSettings | None = None, device="cuda") -> SceneRenderer:
    """Derive transforms, flatten, rasterize on `device`. Returns the renderer (image +
    picking).

    A scene-level EXT_lights_image_based environment (ImageBasedLightComponent)
    becomes the render environment when the settings don't already set one —
    the reference's "imported as Scene IBL" behavior (README.md:93-119)."""
    r.process()
    batch = flatten_scene(r, device=device)
    settings = settings or RenderSettings()
    if settings.environment is None:
        from ..scene.components import ImageBasedLightComponent

        for _, ibl in sorted(r.view(ImageBasedLightComponent), key=lambda kv: kv[0]):
            env = np.asarray(ibl.equirect, np.float32)
            if env.size:
                from dataclasses import replace as _replace

                if not np.allclose(ibl.rotation, (1.0, 0.0, 0.0, 0.0)):
                    from .environment import (
                        cube_faces_from_equirect, equirect_from_cube_faces,
                    )

                    faces = cube_faces_from_equirect(env, max(env.shape[0] // 2, 8),
                                                     rotation=ibl.rotation)
                    env = equirect_from_cube_faces(faces, env.shape[0])
                settings = _replace(settings,
                                    environment=env * np.float32(ibl.intensity))
                break
    if camera is None:
        camera = frame_points(batch.positions)
    return SceneRenderer(batch, camera, settings)


def render_mesh(positions, triangles, camera: Camera | None = None,
                settings: RenderSettings | None = None, vertex_values=None,
                device="cuda") -> np.ndarray:
    """One-mesh convenience (the viz.py entry, through the rasterizer on `device`).
    `vertex_values` colors per-vertex (e.g. a mode shape) with a viridis ramp."""
    dev = resolve_device(device)
    settings = settings or RenderSettings()
    positions = np.asarray(positions, np.float32)
    triangles = np.asarray(triangles, np.int32).reshape(-1, 3)
    if camera is None:
        camera = frame_points(positions)
    normals = vertex_normals(positions, triangles)
    tri_obj = np.zeros(triangles.shape[0], np.int32)
    ss = max(int(settings.supersample), 1)
    rw, rh = settings.width * ss, settings.height * ss
    mvp = view_projection(camera, settings.width, settings.height)
    clip = project_points(mvp, positions, device=dev)
    gbuf = rasterize(clip, triangles, rw, rh, chunk=frame_chunk(settings.chunk, rh, rw, dev),
                     device=dev)
    img = shade(
        gbuf, positions, normals, triangles, tri_obj, MaterialTable.default(1, device=dev),
        LightBank.default(device=dev), eye=np.asarray(camera.eye, np.float32),
        ambient=settings.ambient, background=settings.background,
        flat=settings.mode == "flat",
        wireframe=settings.mode == "wireframe",
        wire_only=settings.mode == "wireframe_only",
    )
    if vertex_values is not None:
        vals = np.asarray(vertex_values, np.float64).reshape(-1)
        vals = (vals - vals.min()) / max(vals.max() - vals.min(), 1e-30)
        vals = torch.as_tensor(vals, device=dev)
        tris = torch.as_tensor(triangles.astype(np.int64), device=dev)
        valid = gbuf.tri >= 0
        vv = vals[tris[torch.clamp(gbuf.tri, min=0).long()]]  # (H, W, 3)
        pix = (gbuf.bary.double() * vv).sum(-1)
        ramp = _viridis(pix)
        shadeamt = img.mean(-1, keepdim=True)  # keep lighting
        img = torch.where(valid[..., None], ramp * (0.35 + 0.65 * shadeamt), img)
    return _downsample(img, settings).cpu().numpy()


_VIRIDIS_STOPS = (
    (0.267, 0.005, 0.329), (0.283, 0.141, 0.458), (0.254, 0.265, 0.530),
    (0.207, 0.372, 0.553), (0.164, 0.471, 0.558), (0.128, 0.567, 0.551),
    (0.135, 0.659, 0.518), (0.267, 0.749, 0.441), (0.478, 0.821, 0.318),
    (0.741, 0.873, 0.150), (0.993, 0.906, 0.144),
)


def _viridis(x: torch.Tensor) -> torch.Tensor:
    """Small fixed-point viridis approximation (no matplotlib dependency here), float64
    on x's device."""
    stops = torch.tensor(_VIRIDIS_STOPS, dtype=torch.float64, device=x.device)
    x = torch.clamp(x.double(), 0.0, 1.0) * (len(_VIRIDIS_STOPS) - 1)
    i = torch.clamp(x.long(), max=len(_VIRIDIS_STOPS) - 2)
    f = (x - i)[..., None]
    return stops[i] * (1 - f) + stops[i + 1] * f


def save_png(path, image: np.ndarray) -> None:
    """Write a float [0,1] RGB image as an 8-bit RGB PNG with the standard library
    (deterministic bytes for corpus diffs)."""
    from .record import encode_png, to_u8

    Path(path).write_bytes(encode_png(to_u8(image)))
