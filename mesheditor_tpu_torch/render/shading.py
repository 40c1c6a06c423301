"""Deferred shading: G-buffer -> lit RGB image, in PyTorch on the G-buffer's device
(counterpart of mesheditor_tpu/render/shading.py).

Metallic-roughness PBR (the reference's glTF-aligned material model,
src/shaders + README.md:85-88 dynamic PBR feature set) with punctual lights
(KHR_lights_punctual semantics: directional / point / spot with smooth cone falloff).
Flat, smooth, and wireframe-overlay modes mirror the reference's mesh render modes
(README.md:22 "flat/smooth shading, wireframe").

Float32 throughout, elementwise multiply-and-sum where the JAX package writes einsums
(never a matmul). The lights are applied in bank order, as the JAX package's scan does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device

LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class MaterialTable(NamedTuple):
    """Per-object material factors (glTF pbrMetallicRoughness), device tensors.

    The optional extension rows carry the shaded KHR_materials_* subset (the
    reference shades the full set through its glTF-Sample-Renderer-derived BRDF,
    README.md:85-119). All-None extension rows keep the legacy shader path (the
    committed render-corpus goldens)."""

    base_color: torch.Tensor  # (O, 4) linear rgba
    metallic: torch.Tensor    # (O,)
    roughness: torch.Tensor   # (O,)
    emissive: torch.Tensor    # (O, 3) — emissive_strength pre-multiplied at build
    # KHR_texture_transform rows [off_u, off_v, rot, scale_u, scale_v]; identity rows
    # leave UVs untouched, so untransformed materials cost nothing extra.
    uv_transform: torch.Tensor = None  # (O, 5) or None
    # Dielectric F0 rgb = ((ior-1)/(ior+1))^2 * specularColor * specular, clipped to
    # [0, 1] (KHR_materials_ior + KHR_materials_specular). None = the 0.04 default.
    f0_color: torch.Tensor = None  # (O, 3) or None
    # [unlit, clearcoat, clearcoat_roughness, sheen_roughness, transmission, specular]
    ext: torch.Tensor = None  # (O, 6) or None
    sheen_color: torch.Tensor = None  # (O, 3) or None

    @staticmethod
    def default(n: int, base_color=(0.48, 0.65, 0.76, 1.0), metallic=0.2, roughness=0.7,
                device="cuda"):
        dev = resolve_device(device)
        n = max(n, 1)
        return MaterialTable(
            base_color=_f32(np.tile(np.asarray(base_color, np.float32), (n, 1)), dev),
            metallic=torch.full((n,), metallic, dtype=torch.float32, device=dev),
            roughness=torch.full((n,), roughness, dtype=torch.float32, device=dev),
            emissive=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        )


class TextureAtlas(NamedTuple):
    """All scene baseColor textures packed into one device tensor (the reference's
    bindless texture table, src/render/Textures.*): per-object rows give the
    sub-rectangle; shading samples bilinearly with REPEAT wrap inside it."""

    atlas: torch.Tensor  # (AH, AW, 3) f32, linear color
    rect: torch.Tensor   # (O, 4) f32: y0, height_px, width_px, has_texture flag


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def build_atlas(textures: list, srgb: bool = True, device="cuda") -> TextureAtlas | None:
    """Pack per-object (h, w, 4) uint8 textures (or None/empty) vertically into one
    atlas on the host, then upload it to `device`. `srgb` decodes color textures to
    linear; normal/ORM/occlusion data stays raw [0, 1]. Returns None when nothing is
    textured."""
    sizes = [(t.shape[0], t.shape[1]) for t in textures
             if t is not None and t.size > 0]
    if not sizes:
        return None
    dev = resolve_device(device)
    aw = max(w for _, w in sizes)
    ah = sum(h for h, _ in sizes)
    atlas = np.zeros((ah, aw, 3), np.float32)
    rect = np.zeros((len(textures), 4), np.float32)
    y = 0
    for i, t in enumerate(textures):
        if t is None or t.size == 0:
            continue
        h, w = t.shape[0], t.shape[1]
        raw = np.asarray(t[..., :3], np.float32) / 255.0
        atlas[y:y + h, :w] = srgb_to_linear(raw) if srgb else raw
        rect[i] = (y, h, w, 1.0)
        y += h
    return TextureAtlas(_f32(atlas, dev), _f32(rect, dev))


class LightBank(NamedTuple):
    """Punctual lights, padded; zero-color entries contribute nothing."""

    kind: torch.Tensor       # (L,) int32
    position: torch.Tensor   # (L, 3) point/spot position
    direction: torch.Tensor  # (L, 3) directional/spot direction (pointing from the light)
    color: torch.Tensor      # (L, 3) color * intensity, linear
    cone_cos: torch.Tensor   # (L, 2) [outer, inner] cos cutoffs for spots

    @staticmethod
    def default(device="cuda"):
        """Key + fill directional pair — the headless default rig."""
        dev = resolve_device(device)
        return LightBank(
            kind=torch.zeros(2, dtype=torch.int32, device=dev),
            position=torch.zeros((2, 3), dtype=torch.float32, device=dev),
            direction=_f32([[-0.5, -0.8, -0.6], [0.7, -0.2, 0.5]], dev),
            color=_f32([[2.6, 2.55, 2.5], [0.7, 0.75, 0.8]], dev),
            cone_cos=torch.zeros((2, 2), dtype=torch.float32, device=dev),
        )

    @staticmethod
    def from_lists(kinds, positions, directions, colors, cones=None, device="cuda"):
        dev = resolve_device(device)
        n = max(len(kinds), 1)
        if not len(kinds):
            return LightBank(torch.zeros(1, dtype=torch.int32, device=dev),
                             torch.zeros((1, 3), dtype=torch.float32, device=dev),
                             _f32([[0, -1, 0]], dev),
                             torch.zeros((1, 3), dtype=torch.float32, device=dev),
                             torch.zeros((1, 2), dtype=torch.float32, device=dev))
        cones = cones if cones is not None else [(0.0, 0.0)] * n
        return LightBank(
            kind=torch.as_tensor(np.asarray(kinds, np.int32), device=dev),
            position=_f32(np.asarray(positions, np.float32).reshape(n, 3), dev),
            direction=_f32(np.asarray(directions, np.float32).reshape(n, 3), dev),
            color=_f32(np.asarray(colors, np.float32).reshape(n, 3), dev),
            cone_cos=_f32(np.asarray(cones, np.float32).reshape(n, 2), dev),
        )


def _dot(a, b, keepdim=False):
    return (a * b).sum(-1, keepdim=keepdim)


def _normalize(v):
    return v / torch.clamp(torch.sqrt(_dot(v, v, keepdim=True)), min=1e-12)


def _pow5(x):
    """x**5 as the JAX package's integer power computes it: x * (x^2)^2."""
    x2 = x * x
    return x * (x2 * x2)


def _ggx_brdf(n, v, l, albedo, metallic, roughness, f0_diel=None, f90=None,
              cc=None, cc_rough=None, sheen_col=None, sheen_rough=None,
              diffuse_scale=None):
    """Cook-Torrance GGX specular + Lambert diffuse, Smith height-correlated.

    Extension lobes (all optional, skipped when None — the reference's
    specialization-constant feature mask, README.md:87): dielectric F0 override
    (ior/specular), clearcoat second GGX lobe at fixed 0.04 F0, Charlie sheen,
    and a diffuse attenuation (transmission removes diffuse energy)."""
    h = _normalize(v + l)
    ndl = torch.clamp(_dot(n, l), min=0.0)
    ndv = torch.clamp(_dot(n, v), min=1e-4)
    ndh = torch.clamp(_dot(n, h), min=0.0)
    vdh = torch.clamp(_dot(v, h), min=0.0)
    a = torch.clamp(roughness * roughness, min=1e-3)
    a2 = a * a
    base = (ndh * ndh) * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * (base * base), min=1e-9)
    r1 = roughness + 1.0
    k = (r1 * r1) / 8.0
    g = (ndv / (ndv * (1 - k) + k)) * (ndl / torch.clamp(ndl * (1 - k) + k, min=1e-9))
    diel = 0.04 if f0_diel is None else f0_diel
    f0 = diel * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    f90v = 1.0 if f90 is None else f90[..., None]
    f = f0 + (f90v - f0) * _pow5(1.0 - vdh[..., None])
    spec = (d[..., None] * g[..., None] * f
            / torch.clamp(4.0 * ndv * ndl, min=1e-9)[..., None])
    kd = (1.0 - f) * (1.0 - metallic[..., None])
    if diffuse_scale is not None:
        kd = kd * diffuse_scale[..., None]
    out = (kd * albedo / math.pi + spec) * ndl[..., None]
    if sheen_col is not None:
        # Charlie NDF (glTF sheen), Ashikhmin visibility approximation.
        sa = torch.clamp(sheen_rough * sheen_rough, min=1e-3)
        inv_a = 1.0 / sa
        sin2h = torch.clamp(1.0 - ndh * ndh, min=1e-6)
        d_ch = (2.0 + inv_a) * torch.pow(sin2h, inv_a * 0.5) / (2.0 * math.pi)
        vis = 1.0 / torch.clamp(4.0 * (ndl + ndv - ndl * ndv), min=1e-6)
        out = out + sheen_col * (d_ch * vis * ndl)[..., None]
    if cc is not None:
        # Clearcoat: second GGX lobe, fixed 1.5-ior (0.04) F0, its own roughness;
        # base layer attenuated by the coat's Fresnel (glTF layering rule).
        ca = torch.clamp(cc_rough * cc_rough, min=1e-3)
        ca2 = ca * ca
        cbase = (ndh * ndh) * (ca2 - 1.0) + 1.0
        d_c = ca2 / torch.clamp(math.pi * (cbase * cbase), min=1e-9)
        c1 = cc_rough + 1.0
        kc = (c1 * c1) / 8.0
        g_c = (ndv / (ndv * (1 - kc) + kc)) * (ndl / torch.clamp(ndl * (1 - kc) + kc,
                                                                 min=1e-9))
        f_c = 0.04 + 0.96 * _pow5(1.0 - vdh)
        spec_c = d_c * g_c * f_c / torch.clamp(4.0 * ndv * ndl, min=1e-9)
        out = out * (1.0 - (cc * f_c)[..., None]) + (cc * spec_c * ndl)[..., None]
    return out


def _sample_atlas(atlas, rect, obj, uv):
    """Bilinear REPEAT-wrapped sample of each pixel's object texture sub-rect.
    uv: (H, W, 2); obj: (H, W) int; returns ((H, W, 3) color, (H, W) flag)."""
    r = rect[obj]  # (H, W, 4)
    y0, th, tw, flag = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    fx = torch.minimum(torch.clamp(u * tw - 0.5, min=0.0), torch.clamp(tw - 1.0, min=0.0))
    fy = torch.minimum(torch.clamp(v * th - 0.5, min=0.0), torch.clamp(th - 1.0, min=0.0))
    x0 = torch.floor(fx)
    y0f = torch.floor(fy)
    ax = (fx - x0)[..., None]
    ay = (fy - y0f)[..., None]
    ah, aw = atlas.shape[0], atlas.shape[1]

    def tex(ix, iy):
        ix = torch.clamp(ix, 0, aw - 1).long()
        iy = torch.clamp(iy, 0, ah - 1).long()
        return atlas[iy, ix]

    gx0 = x0
    gy0 = y0 + y0f
    c = ((1 - ax) * (1 - ay) * tex(gx0, gy0)
         + ax * (1 - ay) * tex(gx0 + 1, gy0)
         + (1 - ax) * ay * tex(gx0, gy0 + 1)
         + ax * ay * tex(gx0 + 1, gy0 + 1))
    return c, flag


def _interp(bary, attr):
    """Barycentric interpolation: sum_k bary[..., k] * attr[..., k, :] (the JAX package's
    "hwk,hwkc->hwc" einsum as an elementwise multiply-and-sum)."""
    return (bary[..., None] * attr).sum(-2)


def _shade_impl(gbuf, positions, normals, tris, tri_obj, materials, lights, extras,
                flat, wireframe, wire_only, uvs=None, tex=None, mr_tex=None,
                em_tex=None, nrm_tex=None, occ_tex=None, tangents=None, env=None):
    depth, tri, bary = gbuf
    eye, ambient, background, wire_color, wire_eps, sky, ground = extras
    valid = tri >= 0
    t = torch.clamp(tri, min=0).long()
    vid = tris[t]                      # (H, W, 3)
    p3 = positions[vid]                # (H, W, 3, 3)
    pos = _interp(bary, p3)
    n_flat = _normalize(torch.linalg.cross(p3[..., 1, :] - p3[..., 0, :],
                                           p3[..., 2, :] - p3[..., 0, :], dim=-1))
    if flat:
        n = n_flat
    else:
        n = _normalize(_interp(bary, normals[vid]))
    view = _normalize(eye - pos)
    # Double-sided: face the viewer (the reference renders mesh interiors too).
    n = torch.where(_dot(n, view, keepdim=True) < 0, -n, n)

    obj = tri_obj[t]
    uv = None
    if uvs is not None:
        uv = _interp(bary, uvs[vid])
        if materials.uv_transform is not None:
            # KHR_texture_transform: UV' = Translate * Rotate * Scale * UV.
            tr = materials.uv_transform[obj]  # (H, W, 5)
            su, sv = uv[..., 0] * tr[..., 3], uv[..., 1] * tr[..., 4]
            cr, sr = torch.cos(tr[..., 2]), torch.sin(tr[..., 2])
            uv = torch.stack([cr * su + sr * sv + tr[..., 0],
                              -sr * su + cr * sv + tr[..., 1]], -1)

    # Tangent-space normal mapping (glTF normalTexture, +Z out): interpolated
    # tangent Gram-Schmidt-orthogonalized against the shading normal.
    if nrm_tex is not None and uv is not None and tangents is not None:
        ts, ts_flag = _sample_atlas(nrm_tex.atlas, nrm_tex.rect, obj, uv)
        tan = _interp(bary, tangents[vid])
        tan = _normalize(tan - n * _dot(tan, n, keepdim=True))
        bit = torch.linalg.cross(n, tan, dim=-1)
        nm = ts * 2.0 - 1.0
        n_mapped = _normalize(nm[..., 0:1] * tan + nm[..., 1:2] * bit
                              + nm[..., 2:3] * n)
        n = torch.where(ts_flag[..., None] > 0, n_mapped, n)

    albedo = materials.base_color[obj][..., :3]
    if tex is not None and uv is not None:
        tex_c, tex_flag = _sample_atlas(tex.atlas, tex.rect, obj, uv)
        albedo = albedo * torch.where(tex_flag[..., None] > 0, tex_c, 1.0)
    metallic = materials.metallic[obj]
    roughness = materials.roughness[obj]
    emissive = materials.emissive[obj]
    if mr_tex is not None and uv is not None:
        # glTF ORM channels: G = roughness, B = metallic; factors multiply.
        mr_c, mr_flag = _sample_atlas(mr_tex.atlas, mr_tex.rect, obj, uv)
        roughness = roughness * torch.where(mr_flag > 0, mr_c[..., 1], 1.0)
        metallic = metallic * torch.where(mr_flag > 0, mr_c[..., 2], 1.0)
    if em_tex is not None and uv is not None:
        em_c, em_flag = _sample_atlas(em_tex.atlas, em_tex.rect, obj, uv)
        emissive = emissive * torch.where(em_flag[..., None] > 0, em_c, 1.0)
    occlusion = 1.0
    if occ_tex is not None and uv is not None:
        oc_c, oc_flag = _sample_atlas(occ_tex.atlas, occ_tex.rect, obj, uv)
        occlusion = torch.where(oc_flag > 0, oc_c[..., 0], 1.0)[..., None]

    # KHR_materials_* per-pixel rows (None when every material is default — the
    # legacy path the committed corpus goldens hold).
    f0_diel = f90 = cc = cc_rough = sheen_col = sheen_rough = None
    transmission = unlit_mask = diffuse_scale = None
    if materials.ext is not None:
        extm = materials.ext[obj]  # (H, W, 6)
        unlit_mask = extm[..., 0]
        cc = extm[..., 1]
        cc_rough = extm[..., 2]
        sheen_rough = extm[..., 3]
        transmission = extm[..., 4]
        f90 = extm[..., 5]  # specularFactor scales the grazing reflectance too
        diffuse_scale = 1.0 - transmission
        if materials.f0_color is not None:
            f0_diel = materials.f0_color[obj]
        if materials.sheen_color is not None:
            sheen_col = materials.sheen_color[obj]

    # Hemisphere environment term (the IBL-lite analog of the reference's prefiltered
    # environment lighting, src/render/IblPrefilterPipelines.h): sky/ground colors
    # blended by the normal's up-ness, replacing the flat ambient when enabled.
    upness = 0.5 * (n[..., 1] + 1.0)
    hemi = sky * upness[..., None] + ground * (1.0 - upness[..., None])

    # Occlusion (glTF occlusionTexture R) darkens only the indirect terms.
    indirect_diffuse = (ambient + hemi) * albedo * occlusion
    if diffuse_scale is not None:
        indirect_diffuse = indirect_diffuse * diffuse_scale[..., None]
    color = emissive + indirect_diffuse
    if env is not None:
        from .environment import shade_ibl

        color = color + shade_ibl(env, n, view, albedo, metallic, roughness) * occlusion

    for i in range(lights.kind.shape[0]):
        kind = lights.kind[i]
        lpos = lights.position[i]
        ldir = _normalize(lights.direction[i])
        lcol = lights.color[i]
        to_light = lpos - pos
        dist2 = torch.clamp(_dot(to_light, to_light), min=1e-9)
        l_point = to_light / torch.sqrt(dist2)[..., None]
        directional = kind == LIGHT_DIRECTIONAL
        l = torch.where(directional, -ldir, l_point)
        atten = torch.where(directional, 1.0, 1.0 / dist2)
        cd = _dot(-l, ldir)
        outer, inner = lights.cone_cos[i, 0], lights.cone_cos[i, 1]
        spot = torch.clamp((cd - outer) / torch.clamp(inner - outer, min=1e-6), 0.0, 1.0)
        atten = torch.where(kind == LIGHT_SPOT, atten * spot * spot, atten)
        contrib = _ggx_brdf(n, view, l, albedo, metallic, roughness,
                            f0_diel=f0_diel, f90=f90, cc=cc, cc_rough=cc_rough,
                            sheen_col=sheen_col, sheen_rough=sheen_rough,
                            diffuse_scale=diffuse_scale)
        color = color + contrib * (lcol * atten[..., None])

    if transmission is not None:
        # KHR_materials_transmission, IBL/background form (the reference's "real
        # transmission off" mode samples the environment, README.md:93-119): the
        # transmitted fraction tints what lies behind by baseColor. Refraction and
        # volume absorption are not modeled.
        if env is not None:
            from .environment import sample_equirect

            behind = sample_equirect(env.specular[0], -view)  # sharpest level
        else:
            behind = background * torch.ones_like(albedo)
        color = color + transmission[..., None] * albedo * behind

    # Reinhard tone map + gamma 2.2 (deterministic, no exposure adaptation).
    color = color / (1.0 + color)
    color = torch.pow(torch.clamp(color, min=0.0), 1.0 / 2.2)
    if unlit_mask is not None:
        # KHR_materials_unlit: baseColor shown as authored — no lighting, no tone map
        # (only the display gamma).
        flat_col = torch.pow(torch.clamp(albedo, min=0.0), 1.0 / 2.2)
        color = torch.where(unlit_mask[..., None] > 0.5, flat_col, color)

    if wireframe or wire_only:
        edge = bary.min(dim=-1).values < wire_eps
        if wire_only:
            color = torch.where((valid & edge)[..., None], wire_color, background)
            return torch.clamp(color, 0.0, 1.0)
        color = torch.where(edge[..., None], wire_color, color)

    color = torch.where(valid[..., None], color, background)
    return torch.clamp(color, 0.0, 1.0)


def shade(gbuf, positions, normals, tris, tri_obj, materials: MaterialTable,
          lights: LightBank, eye, ambient=(0.06, 0.06, 0.07),
          background=(0.125, 0.133, 0.153), flat=False, wireframe=False,
          wire_only=False, wire_color=(0.9, 0.65, 0.1), wire_eps=0.02,
          uvs=None, atlas: TextureAtlas | None = None,
          sky=(0.0, 0.0, 0.0), ground=(0.0, 0.0, 0.0),
          mr_atlas: TextureAtlas | None = None,
          emissive_atlas: TextureAtlas | None = None,
          normal_atlas: TextureAtlas | None = None,
          occlusion_atlas: TextureAtlas | None = None,
          tangents=None, environment=None) -> torch.Tensor:
    """Light the G-buffer on its own device; returns the (H, W, 3) float32 image there.
    positions/normals are world-space per-vertex arrays; tri_obj maps each triangle to
    its object row in `materials`. With `uvs` (N, 2) and TextureAtlases, the full glTF
    texture set modulates the factors: baseColor (sRGB), metallicRoughness (linear ORM
    G/B), emissive (sRGB), occlusion (linear R, indirect light only) and tangent-space
    normals (`tangents` (N, 3) required). Nonzero sky/ground add a hemisphere environment
    term on top of the flat ambient."""
    dev = gbuf.depth.device

    def up(a, cols):
        return torch.as_tensor(np.asarray(a, np.float32).reshape(-1, cols), device=dev)

    tris = torch.as_tensor(np.asarray(tris, np.int64).reshape(-1, 3), device=dev)
    extras = (
        _f32(eye, dev), _f32(ambient, dev), _f32(background, dev), _f32(wire_color, dev),
        float(np.float32(wire_eps)), _f32(sky, dev), _f32(ground, dev),
    )
    uv_arr = None
    any_tex = any(a is not None for a in (atlas, mr_atlas, emissive_atlas,
                                          normal_atlas, occlusion_atlas))
    if any_tex and uvs is not None:
        uv_arr = up(uvs, 2)
    tan_arr = None
    if tangents is not None and normal_atlas is not None:
        tan_arr = up(tangents, 3)
    off = uv_arr is None
    return _shade_impl(
        gbuf, up(positions, 3), up(normals, 3), tris,
        torch.as_tensor(np.asarray(tri_obj, np.int64), device=dev), materials, lights,
        extras, bool(flat), bool(wireframe), bool(wire_only),
        uvs=uv_arr, tex=None if off else atlas,
        mr_tex=None if off else mr_atlas,
        em_tex=None if off else emissive_atlas,
        nrm_tex=None if off or tan_arr is None else normal_atlas,
        occ_tex=None if off else occlusion_atlas,
        tangents=tan_arr,
        env=environment,
    )


def vertex_tangents(positions, tris, uvs) -> np.ndarray:
    """Per-vertex tangents from UV-space triangle derivatives (host-side): the
    standard accumulate-and-normalize used to light glTF normalTexture payloads.
    Degenerate-UV triangles contribute nothing; zero rows fall back to +X."""
    positions = np.asarray(positions, np.float64)
    uvs = np.asarray(uvs, np.float64)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    e1 = positions[tris[:, 1]] - positions[tris[:, 0]]
    e2 = positions[tris[:, 2]] - positions[tris[:, 0]]
    d1 = uvs[tris[:, 1]] - uvs[tris[:, 0]]
    d2 = uvs[tris[:, 2]] - uvs[tris[:, 0]]
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    ok = np.abs(det) > 1e-20
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tan = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * inv[:, None]
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, tris[:, k], tan)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    out = np.divide(out, norm, out=np.zeros_like(out), where=norm > 1e-20)
    out[np.all(out == 0, axis=1)] = (1.0, 0.0, 0.0)
    return out.astype(np.float32)


def vertex_normals(positions, tris) -> np.ndarray:
    """Area-weighted smooth vertex normals (host-side, reused by exports)."""
    positions = np.asarray(positions, np.float64)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    fn = np.cross(positions[tris[:, 1]] - positions[tris[:, 0]],
                  positions[tris[:, 2]] - positions[tris[:, 0]])
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, tris[:, k], fn)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    out = np.divide(out, norm, out=np.zeros_like(out), where=norm > 1e-20)
    return out.astype(np.float32)
