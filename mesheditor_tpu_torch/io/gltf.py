"""glTF 2.0 scene import/export (pure Python: JSON + external/GLB binary buffers).

Covers the framework's scene-interchange slice of the reference's glTF layer
(src/gltf/GltfScene.{h,cpp}): node hierarchy with TRS transforms, triangle meshes
(POSITION/NORMAL + indices), pbrMetallicRoughness material factors, and two custom
extras blocks carrying this framework's physical-audio data:

- `MESHEDITOR_TPU_acoustic`: acoustic material (rho, E, nu, alpha, beta) + solve settings
- `MESHEDITOR_TPU_modal`: a bound modal model artifact path (content-addressed)

plus the reference's interchange extension `KHR_audio_rigid_bodies`
(GltfScene.cpp:2415-2555 import, :4462-4552 export): document-level acoustic materials
and modal models (frequencies / decayRates = ln1000/T60 / positions / MODE-MAJOR shape
vectors / mass properties, all as accessors), attached per node with a gain. Solved
models therefore travel inside the .glb itself — no sidecar artifact needed.

Import -> a scene Registry; export <- a Registry. Lossless roundtrip for everything this
slice covers (tested component-by-component, the reference's RoundtripTest discipline).
GLB (binary container) and .gltf+.bin layouts both supported.

Counterpart of mesheditor_tpu/io/gltf.py, its numpy code as it is: the same scene gives
the same components, snapshot bytes and (untextured) export JSON in both packages. PNG
images are encoded and decoded with zlib (`render.record`), so PNG textures and the IBL
cube faces need no PIL; JPEG and WebP images need PIL, and zstd-supercompressed KTX2 needs
`zstandard`. A missing package raises an ImportError naming the format: no texture is
dropped for want of a decoder.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

from ..render.record import decode_png, encode_png
from ..scene.components import (
    AcousticMaterialRef,
    LightComponent,
    MeshSurface,
    ModalGainComponent,
    ModalModel,
    Name,
    RigidBodyComponent,
    SceneNode,
    SolveSettingsComponent,
    Transform,
    VisibilityComponent,
    VisualMaterial,
)
from ..scene.registry import Registry

_COMP_F32 = 5126
_COMP_U32 = 5125
_COMP_U16 = 5123


def _accessor(gltf, buffers, arr, target=None):
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        comp = _COMP_F32
    elif arr.dtype == np.uint32:
        comp = _COMP_U32
    elif arr.dtype == np.uint16:
        comp = _COMP_U16
    else:
        raise ValueError(f"unsupported accessor dtype {arr.dtype}")
    if arr.ndim == 1:
        type_ = "SCALAR"
    elif arr.shape[1] == 3:
        type_ = "VEC3"
    elif arr.shape[1] == 2:
        type_ = "VEC2"
    elif arr.shape[1] == 4:
        type_ = "VEC4"
    else:
        raise ValueError(f"unsupported accessor shape {arr.shape}")
    data = arr.tobytes()
    offset = len(buffers)
    pad = (-offset) % 4
    buffers.extend(b"\x00" * pad)
    offset += pad
    buffers.extend(data)
    gltf["bufferViews"].append(
        {"buffer": 0, "byteOffset": offset, "byteLength": len(data), **({"target": target} if target else {})}
    )
    acc = {
        "bufferView": len(gltf["bufferViews"]) - 1,
        "componentType": comp,
        "count": int(arr.shape[0]),
        "type": type_,
    }
    if type_ == "VEC3" and comp == _COMP_F32:
        acc["min"] = [float(v) for v in arr.min(axis=0)]
        acc["max"] = [float(v) for v in arr.max(axis=0)]
    gltf["accessors"].append(acc)
    return len(gltf["accessors"]) - 1


_LN1000 = float(np.log(1000.0))


def _export_modal_model(gltf, buffers, modes, mass, material_index, name):
    """One KHR_audio_rigid_bodies modalModels entry (reference wire format,
    GltfScene.cpp:4506-4552): decayRates d = ln1000/T60 (0 = undamped sentinel);
    shapes mode-major (element m*P + i is mode m at sample point i)."""
    t60s = np.asarray(modes.t60s, np.float64)
    decay = np.where(t60s > 0, _LN1000 / np.maximum(t60s, 1e-300), 0.0).astype(np.float32)
    shapes_km = np.ascontiguousarray(
        np.asarray(modes.shapes, np.float32).transpose(1, 0, 2)
    ).reshape(-1, 3)  # (K*P, 3) mode-major
    entry = {
        "frequencies": _accessor(gltf, buffers, np.asarray(modes.freqs, np.float32)),
        "decayRates": _accessor(gltf, buffers, decay),
        "positions": _accessor(gltf, buffers, np.asarray(modes.positions, np.float32)),
        "shapes": _accessor(gltf, buffers, shapes_km),
        "name": name,
    }
    if modes.indices.size:
        entry["indices"] = _accessor(gltf, buffers, np.asarray(modes.indices, np.uint32))
    if material_index is not None:
        entry["material"] = material_index
    if mass is not None and mass.mass > 0:
        w, x, y, z = (float(v) for v in mass.inertia_orientation)
        entry["massProperties"] = {
            "mass": float(mass.mass),
            "centerOfMass": [float(v) for v in mass.center_of_mass],
            "inertiaDiagonal": [float(v) for v in mass.inertia_diagonal],
            "inertiaOrientation": [x, y, z, w],  # glTF quaternion order xyzw
        }
    return entry


def _mark_used(gltf, name: str) -> None:
    used = gltf.setdefault("extensionsUsed", [])
    if name not in used:
        used.append(name)


def _export_material_extensions(gltf, entry: dict, vm) -> None:
    """Write the KHR_materials_* extension blocks a VisualMaterial departs from
    defaults on (the reference supports the full set, README.md:93-119). Every block
    is omitted at its spec default so plain materials stay minimal."""
    ext: dict = {}
    g = lambda name, d: getattr(vm, name, d)  # noqa: E731
    if g("emissive_strength", 1.0) != 1.0:
        ext["KHR_materials_emissive_strength"] = {
            "emissiveStrength": float(vm.emissive_strength)}
    if g("unlit", False):
        ext["KHR_materials_unlit"] = {}
    if g("ior", 1.5) != 1.5:
        ext["KHR_materials_ior"] = {"ior": float(vm.ior)}
    spec = {}
    if g("specular", 1.0) != 1.0:
        spec["specularFactor"] = float(vm.specular)
    if np.any(np.asarray(g("specular_color", np.ones(3))) != 1.0):
        spec["specularColorFactor"] = [float(v) for v in vm.specular_color]
    if spec:
        ext["KHR_materials_specular"] = spec
    if g("clearcoat", 0.0):
        ext["KHR_materials_clearcoat"] = {
            "clearcoatFactor": float(vm.clearcoat),
            "clearcoatRoughnessFactor": float(g("clearcoat_roughness", 0.0)),
        }
    if np.any(np.asarray(g("sheen_color", np.zeros(3))) != 0.0):
        ext["KHR_materials_sheen"] = {
            "sheenColorFactor": [float(v) for v in vm.sheen_color],
            "sheenRoughnessFactor": float(g("sheen_roughness", 0.0)),
        }
    if g("transmission", 0.0):
        ext["KHR_materials_transmission"] = {
            "transmissionFactor": float(vm.transmission)}
    if g("diffuse_transmission", 0.0):
        ext["KHR_materials_diffuse_transmission"] = {
            "diffuseTransmissionFactor": float(vm.diffuse_transmission),
            "diffuseTransmissionColorFactor": [
                float(v) for v in g("diffuse_transmission_color", np.ones(3))],
        }
    if g("thickness", 0.0) or g("attenuation_distance", 0.0):
        vol = {"thicknessFactor": float(g("thickness", 0.0))}
        if g("attenuation_distance", 0.0):
            vol["attenuationDistance"] = float(vm.attenuation_distance)
        if np.any(np.asarray(g("attenuation_color", np.ones(3))) != 1.0):
            vol["attenuationColor"] = [float(v) for v in vm.attenuation_color]
        ext["KHR_materials_volume"] = vol
    if g("dispersion", 0.0):
        ext["KHR_materials_dispersion"] = {"dispersion": float(vm.dispersion)}
    if g("anisotropy_strength", 0.0):
        ext["KHR_materials_anisotropy"] = {
            "anisotropyStrength": float(vm.anisotropy_strength),
            "anisotropyRotation": float(g("anisotropy_rotation", 0.0)),
        }
    if g("iridescence", 0.0):
        ext["KHR_materials_iridescence"] = {
            "iridescenceFactor": float(vm.iridescence),
            "iridescenceIor": float(g("iridescence_ior", 1.3)),
            "iridescenceThicknessMinimum": float(g("iridescence_thickness_min", 100.0)),
            "iridescenceThicknessMaximum": float(g("iridescence_thickness_max", 400.0)),
        }
    if ext:
        entry["extensions"] = ext
        for name in ext:
            _mark_used(gltf, name)


def _import_material_extensions(m: dict, kwargs: dict) -> None:
    """Parse the KHR_materials_* blocks into VisualMaterial constructor kwargs."""
    ext = m.get("extensions") or {}

    def block(name):
        return ext.get(name)

    b = block("KHR_materials_emissive_strength")
    if b:
        kwargs["emissive_strength"] = float(b.get("emissiveStrength", 1.0))
    if block("KHR_materials_unlit") is not None:
        kwargs["unlit"] = True
    b = block("KHR_materials_ior")
    if b:
        kwargs["ior"] = float(b.get("ior", 1.5))
    b = block("KHR_materials_specular")
    if b:
        kwargs["specular"] = float(b.get("specularFactor", 1.0))
        kwargs["specular_color"] = np.asarray(
            b.get("specularColorFactor", [1.0, 1.0, 1.0]), np.float64)
    b = block("KHR_materials_clearcoat")
    if b:
        kwargs["clearcoat"] = float(b.get("clearcoatFactor", 0.0))
        kwargs["clearcoat_roughness"] = float(b.get("clearcoatRoughnessFactor", 0.0))
    b = block("KHR_materials_sheen")
    if b:
        kwargs["sheen_color"] = np.asarray(
            b.get("sheenColorFactor", [0.0, 0.0, 0.0]), np.float64)
        kwargs["sheen_roughness"] = float(b.get("sheenRoughnessFactor", 0.0))
    b = block("KHR_materials_transmission")
    if b:
        kwargs["transmission"] = float(b.get("transmissionFactor", 0.0))
    b = block("KHR_materials_diffuse_transmission")
    if b:
        kwargs["diffuse_transmission"] = float(b.get("diffuseTransmissionFactor", 0.0))
        kwargs["diffuse_transmission_color"] = np.asarray(
            b.get("diffuseTransmissionColorFactor", [1.0, 1.0, 1.0]), np.float64)
    b = block("KHR_materials_volume")
    if b:
        kwargs["thickness"] = float(b.get("thicknessFactor", 0.0))
        kwargs["attenuation_distance"] = float(b.get("attenuationDistance", 0.0))
        kwargs["attenuation_color"] = np.asarray(
            b.get("attenuationColor", [1.0, 1.0, 1.0]), np.float64)
    b = block("KHR_materials_dispersion")
    if b:
        kwargs["dispersion"] = float(b.get("dispersion", 0.0))
    b = block("KHR_materials_anisotropy")
    if b:
        kwargs["anisotropy_strength"] = float(b.get("anisotropyStrength", 0.0))
        kwargs["anisotropy_rotation"] = float(b.get("anisotropyRotation", 0.0))
    b = block("KHR_materials_iridescence")
    if b:
        kwargs["iridescence"] = float(b.get("iridescenceFactor", 0.0))
        kwargs["iridescence_ior"] = float(b.get("iridescenceIor", 1.3))
        kwargs["iridescence_thickness_min"] = float(
            b.get("iridescenceThicknessMinimum", 100.0))
        kwargs["iridescence_thickness_max"] = float(
            b.get("iridescenceThicknessMaximum", 400.0))


_TEXTURE_KEYS = ("baseColorTexture", "metallicRoughnessTexture", "emissiveTexture",
                 "normalTexture", "occlusionTexture")


def _strip_texture_refs(m: dict) -> dict:
    """A deep-copied glTF material dict with texture references removed (variant
    mappings store factors only — texture indices are document-local)."""
    import copy

    m = copy.deepcopy(m)
    m.pop("normalTexture", None)
    m.pop("occlusionTexture", None)
    m.pop("emissiveTexture", None)
    pbr = m.get("pbrMetallicRoughness")
    if pbr:
        pbr.pop("baseColorTexture", None)
        pbr.pop("metallicRoughnessTexture", None)
    return m


def _material_factor_kwargs(m: dict) -> dict:
    """VisualMaterial factor kwargs from a glTF material dict (no textures)."""
    pbr = m.get("pbrMetallicRoughness", {})
    kwargs = dict(
        base_color=np.asarray(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]),
                              np.float64),
        metallic=float(pbr.get("metallicFactor", 1.0)),
        roughness=float(pbr.get("roughnessFactor", 1.0)),
        emissive=np.asarray(m.get("emissiveFactor", [0.0, 0.0, 0.0]), np.float64),
        double_sided=bool(m.get("doubleSided", False)),
        alpha_mode=m.get("alphaMode", "OPAQUE"),
        alpha_cutoff=float(m.get("alphaCutoff", 0.5)),
    )
    _import_material_extensions(m, kwargs)
    return kwargs


def apply_variant(r: Registry, name: str) -> int:
    """Activate a KHR_materials_variants variant by name: every entity whose
    MaterialVariants mappings cover the variant gets its VisualMaterial factor
    fields rewritten (textures stay). Returns the number of entities updated."""
    from ..scene.components import MaterialVariants

    changed = 0
    for e, mv in list(r.view(MaterialVariants)):
        if name not in mv.names:
            continue
        idx = mv.names.index(name)
        for mapping in mv.mappings:
            if idx in mapping.get("variants", []):
                kwargs = _material_factor_kwargs(mapping.get("material", {}))
                vm = r.get(e, VisualMaterial) or VisualMaterial()
                for k, v in kwargs.items():
                    setattr(vm, k, v)
                r.emplace(e, vm)
                changed += 1
                break
    return changed


def _compute_normals(positions, tris):
    n = np.zeros_like(positions)
    v = positions[tris]
    face_n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    for k in range(3):
        np.add.at(n, tris[:, k], face_n)
    norms = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(norms, 1e-30)).astype(np.float32)


def export_gltf(r: Registry, path, texture_format: str = "png") -> None:
    """Write the registry's scene as .glb (binary) or .gltf (+ sidecar .bin).

    texture_format="webp" re-encodes every texture payload as LOSSLESS WebP carried
    by EXT_texture_webp (the reference's export behavior for edited textures,
    README.md:93-119); "png" (default) writes core-glTF PNG images."""
    path = Path(path)
    gltf = {
        "asset": {"version": "2.0", "generator": "mesheditor_tpu"},
        "scene": 0,
        "scenes": [{"nodes": []}],
        "nodes": [],
        "meshes": [],
        "materials": [],
        "accessors": [],
        "bufferViews": [],
        "buffers": [],
    }
    buffers = bytearray()
    node_index: dict[int, int] = {}
    variant_names: list[str] = []
    ibl_lights: list = []
    audio_ext = {"acousticMaterials": [], "modalModels": []}

    def _embed_png(pixels_uint8) -> int:
        """Embed an RGB(A) uint8 array as a PNG image; returns the image index."""
        data = encode_png(pixels_uint8)
        off = len(buffers)
        buffers.extend(data)
        buffers.extend(b"\x00" * ((-len(data)) % 4))
        gltf.setdefault("bufferViews", []).append(
            {"buffer": 0, "byteOffset": off, "byteLength": len(data)})
        gltf.setdefault("images", []).append(
            {"bufferView": len(gltf["bufferViews"]) - 1, "mimeType": "image/png"})
        return len(gltf["images"]) - 1
    audio_material_index: dict[tuple, int] = {}
    implicit_shapes: list = []
    implicit_shape_index: dict[tuple, int] = {}
    punctual_lights: list = []
    physics_used = [False]
    entities = sorted(e for e in r.entities() if r.valid(e))
    for e in entities:
        node: dict = {}
        name = r.get(e, Name)
        if name and name.value:
            node["name"] = name.value
        t = r.get(e, Transform)
        if t is not None:
            if np.any(t.translation != 0):
                node["translation"] = [float(v) for v in t.translation]
            w, x, y, z = t.rotation
            if (w, x, y, z) != (1.0, 0.0, 0.0, 0.0):
                node["rotation"] = [float(x), float(y), float(z), float(w)]  # glTF xyzw
            if np.any(t.scale != 1):
                node["scale"] = [float(v) for v in t.scale]
        mesh = r.get(e, MeshSurface)
        if mesh is not None and mesh.positions.size:
            pos = np.asarray(mesh.positions, np.float32)
            tris = np.asarray(mesh.triangles, np.uint32)
            pos_acc = _accessor(gltf, buffers, pos, target=34962)
            nrm_acc = _accessor(gltf, buffers, _compute_normals(pos.astype(np.float64), tris.astype(np.int64)), target=34962)
            idx_acc = _accessor(gltf, buffers, tris.reshape(-1), target=34963)
            prim = {
                "attributes": {"POSITION": pos_acc, "NORMAL": nrm_acc},
                "indices": idx_acc,
            }
            uvs = np.asarray(mesh.uvs, np.float32)
            if uvs.shape[0] == pos.shape[0] and uvs.size:
                prim["attributes"]["TEXCOORD_0"] = _accessor(gltf, buffers, uvs,
                                                             target=34962)
            if mesh.morph_targets.shape[0]:
                prim["targets"] = [
                    {"POSITION": _accessor(gltf, buffers,
                                           np.asarray(tgt, np.float32), target=34962)}
                    for tgt in mesh.morph_targets
                ]
            mat = r.get(e, AcousticMaterialRef)
            vm = r.get(e, VisualMaterial)
            if vm is not None or mat is not None:
                # pbrMetallicRoughness factors from VisualMaterial when present; an
                # acoustic-only entity keeps the legacy preview factors.
                if vm is None:
                    vm = VisualMaterial()
                entry = {
                    "pbrMetallicRoughness": {
                        "baseColorFactor": [float(v) for v in vm.base_color],
                        "metallicFactor": float(vm.metallic),
                        "roughnessFactor": float(vm.roughness),
                    },
                    "doubleSided": bool(vm.double_sided),
                }
                if np.any(np.asarray(vm.emissive) != 0):
                    entry["emissiveFactor"] = [float(v) for v in vm.emissive]
                if getattr(vm, "alpha_mode", "OPAQUE") != "OPAQUE":
                    entry["alphaMode"] = vm.alpha_mode
                    if vm.alpha_mode == "MASK" and vm.alpha_cutoff != 0.5:
                        entry["alphaCutoff"] = float(vm.alpha_cutoff)
                _export_material_extensions(gltf, entry, vm)
                def _embed_texture(pixels) -> dict:
                    # Embed a texture image (PNG, or lossless WebP behind
                    # EXT_texture_webp); returns textureInfo.
                    webp = texture_format == "webp"
                    data = _encode_webp(pixels) if webp else encode_png(pixels)
                    off = len(buffers)
                    buffers.extend(data)
                    buffers.extend(b"\x00" * ((-len(data)) % 4))
                    gltf.setdefault("bufferViews", []).append(
                        {"buffer": 0, "byteOffset": off, "byteLength": len(data)})
                    gltf.setdefault("images", []).append(
                        {"bufferView": len(gltf["bufferViews"]) - 1,
                         "mimeType": "image/webp" if webp else "image/png"})
                    gltf.setdefault("samplers", [{"wrapS": 10497, "wrapT": 10497}])
                    img_index = len(gltf["images"]) - 1
                    if webp:
                        # No core fallback image is written, so the extension is
                        # REQUIRED (EXT_texture_webp spec).
                        tex_entry = {"sampler": 0, "extensions": {
                            "EXT_texture_webp": {"source": img_index}}}
                        _mark_used(gltf, "EXT_texture_webp")
                        req = gltf.setdefault("extensionsRequired", [])
                        if "EXT_texture_webp" not in req:
                            req.append("EXT_texture_webp")
                    else:
                        tex_entry = {"source": img_index, "sampler": 0}
                    gltf.setdefault("textures", []).append(tex_entry)
                    info = {"index": len(gltf["textures"]) - 1}
                    tr = np.asarray(getattr(vm, "uv_transform", (0, 0, 0, 1, 1)),
                                    np.float64).reshape(-1)
                    if tr.size == 5 and not np.allclose(tr, (0, 0, 0, 1, 1)):
                        info["extensions"] = {"KHR_texture_transform": {
                            "offset": [float(tr[0]), float(tr[1])],
                            "rotation": float(tr[2]),
                            "scale": [float(tr[3]), float(tr[4])],
                        }}
                        _mark_used(gltf, "KHR_texture_transform")
                    return info

                tex = np.asarray(getattr(vm, "texture", np.zeros((0, 0, 4), np.uint8)))
                if tex.size:
                    entry["pbrMetallicRoughness"]["baseColorTexture"] = \
                        _embed_texture(tex)
                mr = np.asarray(getattr(vm, "mr_texture", np.zeros((0, 0, 4), np.uint8)))
                if mr.size:
                    entry["pbrMetallicRoughness"]["metallicRoughnessTexture"] = \
                        _embed_texture(mr)
                em = np.asarray(getattr(vm, "emissive_texture",
                                        np.zeros((0, 0, 4), np.uint8)))
                if em.size:
                    # emissiveFactor multiplies the texture (glTF spec); authors set
                    # emissive=(1,1,1) for unscaled texture emission.
                    entry["emissiveTexture"] = _embed_texture(em)
                nm = np.asarray(getattr(vm, "normal_texture",
                                        np.zeros((0, 0, 4), np.uint8)))
                if nm.size:
                    entry["normalTexture"] = _embed_texture(nm)
                oc = np.asarray(getattr(vm, "occlusion_texture",
                                        np.zeros((0, 0, 4), np.uint8)))
                if oc.size:
                    entry["occlusionTexture"] = _embed_texture(oc)
                if mat is not None:
                    entry["name"] = mat.name
                gltf["materials"].append(entry)
                prim["material"] = len(gltf["materials"]) - 1
            # KHR_materials_variants: document-level name list (union across
            # entities) + per-primitive mappings referencing appended materials.
            from ..scene.components import MaterialVariants

            mv = r.get(e, MaterialVariants)
            if mv is not None and mv.names and mv.mappings:
                remap = {}
                for i, nm in enumerate(mv.names):
                    if nm not in variant_names:
                        variant_names.append(nm)
                    remap[i] = variant_names.index(nm)
                out_mappings = []
                for mapping in mv.mappings:
                    mdict = _strip_texture_refs(mapping.get("material", {}))
                    gltf["materials"].append(mdict)
                    for xname in (mdict.get("extensions") or {}):
                        _mark_used(gltf, xname)
                    out_mappings.append({
                        "material": len(gltf["materials"]) - 1,
                        "variants": sorted(remap[i]
                                           for i in mapping.get("variants", [])
                                           if i in remap),
                    })
                prim.setdefault("extensions", {})["KHR_materials_variants"] = {
                    "mappings": out_mappings}
                _mark_used(gltf, "KHR_materials_variants")
            mesh_entry: dict = {"primitives": [prim]}
            if mesh.morph_weights.shape[0]:
                mesh_entry["weights"] = [float(w) for w in mesh.morph_weights]
            gltf["meshes"].append(mesh_entry)
            node["mesh"] = len(gltf["meshes"]) - 1
        extras = {}
        mat = r.get(e, AcousticMaterialRef)
        if mat is not None:
            extras["MESHEDITOR_TPU_acoustic"] = {
                "name": mat.name, "density": mat.density, "youngModulus": mat.young_modulus,
                "poissonRatio": mat.poisson_ratio, "alpha": mat.alpha, "beta": mat.beta,
            }
        ss = r.get(e, SolveSettingsComponent)
        if ss is not None:
            extras["MESHEDITOR_TPU_solve"] = {
                "numVertices": ss.num_vertices, "solveResolution": ss.solve_resolution,
                "numModes": ss.num_modes, "minModeFreq": ss.min_mode_freq,
                "maxModeFreq": ss.max_mode_freq,
            }
        mm = r.get(e, ModalModel)
        if mm is not None and mm.path:
            extras["MESHEDITOR_TPU_modal"] = {"path": mm.path}
        if extras:
            node["extras"] = extras

        # KHR_audio_rigid_bodies: embed the solved model itself when its artifact is
        # readable, referencing a deduped document-level acoustic material.
        mat_idx = None
        if mat is not None:
            key = (mat.name, mat.density, mat.young_modulus, mat.poisson_ratio,
                   mat.alpha, mat.beta)
            if key not in audio_material_index:
                audio_material_index[key] = len(audio_ext["acousticMaterials"])
                audio_ext["acousticMaterials"].append({
                    "name": mat.name, "density": mat.density,
                    "youngsModulus": mat.young_modulus, "poissonRatio": mat.poisson_ratio,
                    "alpha": mat.alpha, "beta": mat.beta,
                })
            mat_idx = audio_material_index[key]
        if mm is not None and mm.path and Path(mm.path).exists():
            from .model_store import load_modal_model

            modes, mass = load_modal_model(mm.path)
            if modes.num_modes:
                gain = r.get(e, ModalGainComponent)
                node.setdefault("extensions", {})["KHR_audio_rigid_bodies"] = {
                    "modalModel": len(audio_ext["modalModels"]),
                    "gain": float(gain.value) if gain else 1.0,
                }
                audio_ext["modalModels"].append(_export_modal_model(
                    gltf, buffers, modes, mass, mat_idx, node.get("name", "")
                ))
        # EXT_lights_image_based: equirect -> cubemap faces + SH9 irradiance (the
        # extension's wire format; level-0 faces only — the consumer prefilters).
        from ..scene.components import ImageBasedLightComponent

        ibl = r.get(e, ImageBasedLightComponent)
        if ibl is not None and np.asarray(ibl.equirect).size:
            from ..render.environment import (
                cube_faces_from_equirect, sh9_irradiance_coefficients,
            )

            env = np.asarray(ibl.equirect, np.float32)
            size = max(8, min(128, env.shape[0] // 2 * 2))
            faces = cube_faces_from_equirect(env, size)
            srgb = np.clip(np.where(faces <= 0.0031308, faces * 12.92,
                                    1.055 * np.maximum(faces, 1e-9) ** (1 / 2.4)
                                    - 0.055), 0.0, 1.0)
            face_ids = [_embed_png((srgb[f] * 255.0 + 0.5).astype(np.uint8))
                        for f in range(6)]
            w_, x_, y_, z_ = (float(v) for v in ibl.rotation)
            ibl_entry = {
                "intensity": float(ibl.intensity),
                "rotation": [x_, y_, z_, w_],
                "irradianceCoefficients": [
                    [float(v) for v in row]
                    for row in sh9_irradiance_coefficients(env)],
                "specularImages": [face_ids],
                "specularImageSize": size,
            }
            node.setdefault("extensions", {})["EXT_lights_image_based"] = {
                "light": len(ibl_lights)}
            ibl_lights.append(ibl_entry)
            _mark_used(gltf, "EXT_lights_image_based")

        # KHR_node_visibility: only non-default (hidden) nodes carry the block.
        vis = r.get(e, VisibilityComponent)
        if vis is not None and not vis.visible:
            node.setdefault("extensions", {})["KHR_node_visibility"] = {
                "visible": False}
            _mark_used(gltf, "KHR_node_visibility")
        # KHR_physics_rigid_bodies + KHR_implicit_shapes: collider shape + motion
        # (reference export shape, GltfScene.cpp:4150-4180).
        # KHR_lights_punctual: document-level light list + node reference.
        lc = r.get(e, LightComponent)
        if lc is not None:
            light_entry: dict = {
                "type": lc.kind,
                "color": [float(v) for v in lc.color],
                "intensity": float(lc.intensity),
            }
            if lc.range > 0:
                light_entry["range"] = float(lc.range)
            if lc.kind == "spot":
                light_entry["spot"] = {
                    "innerConeAngle": float(lc.inner_cone_angle),
                    "outerConeAngle": float(lc.outer_cone_angle),
                }
            node.setdefault("extensions", {})["KHR_lights_punctual"] = {
                "light": len(punctual_lights)
            }
            punctual_lights.append(light_entry)
        rb = r.get(e, RigidBodyComponent)
        if rb is not None:
            if rb.shape_kind in ("mesh", "convex"):
                # Mesh geometry references the node itself (the spec's node-geometry
                # collider; reference maps it to a TriangleMesh, GltfScene.cpp:1680-1683).
                # `convexHull: true` marks a convex collider over the same vertices.
                key = None
                shape = None
            elif rb.shape_kind == "capsule":
                key = ("capsule", float(rb.radius), float(rb.half_height))
                shape = {"type": "capsule",
                         "capsule": {"height": float(rb.half_height) * 2,
                                     "radiusBottom": float(rb.radius),
                                     "radiusTop": float(rb.radius)}}
            elif rb.shape_kind == "cylinder":
                key = ("cylinder", float(rb.radius), float(rb.half_height))
                shape = {"type": "cylinder",
                         "cylinder": {"height": float(rb.half_height) * 2,
                                      "radiusBottom": float(rb.radius),
                                      "radiusTop": float(rb.radius)}}
            elif rb.shape_kind == "box":
                size = [float(v) * 2 for v in rb.half_extents]  # wire carries full size
                key = ("box", *size)
                shape = {"type": "box", "box": {"size": size}}
            elif rb.shape_kind == "plane":
                key = ("plane", *[float(v) for v in rb.plane_normal], float(rb.plane_offset))
                shape = {"type": "plane",
                         "plane": {"normal": [float(v) for v in rb.plane_normal],
                                   "offset": float(rb.plane_offset)}}
            else:
                key = ("sphere", float(rb.radius))
                shape = {"type": "sphere", "sphere": {"radius": float(rb.radius)}}
            if shape is None:
                geometry = {"node": len(gltf["nodes"])}  # this node's own mesh
                if rb.shape_kind == "convex":
                    geometry["convexHull"] = True
            else:
                if key not in implicit_shape_index:
                    implicit_shape_index[key] = len(implicit_shapes)
                    implicit_shapes.append(shape)
                geometry = {"shape": implicit_shape_index[key]}
            physics_used[0] = True
            body: dict = {"collider": {"geometry": geometry}}
            if rb.is_dynamic or rb.is_kinematic:
                motion = {"isKinematic": bool(rb.is_kinematic)}
                if rb.mass > 0:
                    motion["mass"] = float(rb.mass)
                if rb.gravity_factor != 1.0:
                    motion["gravityFactor"] = float(rb.gravity_factor)
                if np.any(np.asarray(rb.linear_velocity) != 0):
                    motion["linearVelocity"] = [float(v) for v in rb.linear_velocity]
                if np.any(np.asarray(rb.angular_velocity) != 0):
                    motion["angularVelocity"] = [float(v) for v in rb.angular_velocity]
                body["motion"] = motion
            node.setdefault("extensions", {})["KHR_physics_rigid_bodies"] = body
        node_index[e] = len(gltf["nodes"])
        gltf["nodes"].append(node)
    # Hierarchy.
    for e in entities:
        sn = r.get(e, SceneNode)
        parent = sn.parent if sn else 0
        if parent and parent in node_index:
            gltf["nodes"][node_index[parent]].setdefault("children", []).append(node_index[e])
        else:
            gltf["scenes"][0]["nodes"].append(node_index[e])

    # Animations: every AnimationClipComponent becomes one document animation with
    # per-channel samplers (times/values accessors; rotation converts wxyz -> xyzw,
    # CUBICSPLINE flattens (k, 3, d) to the spec's 3k rows).
    from ..scene.animation import AnimationClipComponent, Interpolation, TargetPath

    animations = []
    for e in entities:
        acc_comp = r.get(e, AnimationClipComponent)
        if acc_comp is None or not acc_comp.clip.channels:
            continue
        channels = []
        samplers = []
        for c in acc_comp.clip.channels:
            if c.entity not in node_index:
                continue
            vals = np.asarray(c.values, np.float32)
            if c.interpolation == Interpolation.CUBICSPLINE:
                vals = vals.reshape(-1, vals.shape[-1])
            if c.path == TargetPath.ROTATION:
                if c.interpolation == Interpolation.CUBICSPLINE:
                    vals = vals[:, [1, 2, 3, 0]]
                else:
                    vals = vals[:, [1, 2, 3, 0]]  # wxyz -> xyzw
            if c.path == TargetPath.WEIGHTS:
                vals = vals.reshape(-1)
            t_acc = _accessor(gltf, buffers, np.asarray(c.times, np.float32))
            v_acc = _accessor(gltf, buffers, vals)
            samplers.append({"input": t_acc, "output": v_acc,
                             "interpolation": c.interpolation.value})
            channels.append({"sampler": len(samplers) - 1,
                             "target": {"node": node_index[c.entity],
                                        "path": c.path.value}})
        if channels:
            anim = {"channels": channels, "samplers": samplers}
            if acc_comp.clip.name:
                anim["name"] = acc_comp.clip.name
            animations.append(anim)
    if animations:
        gltf["animations"] = animations

    doc_ext = {}
    used = []
    if audio_ext["modalModels"] or audio_ext["acousticMaterials"]:
        doc_ext["KHR_audio_rigid_bodies"] = audio_ext
        used.append("KHR_audio_rigid_bodies")
    if implicit_shapes:
        doc_ext["KHR_implicit_shapes"] = {"shapes": implicit_shapes}
        used.append("KHR_implicit_shapes")
    if physics_used[0]:
        used.append("KHR_physics_rigid_bodies")
    if punctual_lights:
        doc_ext["KHR_lights_punctual"] = {"lights": punctual_lights}
        used.append("KHR_lights_punctual")
    if variant_names:
        doc_ext["KHR_materials_variants"] = {
            "variants": [{"name": n} for n in variant_names]}
        used.append("KHR_materials_variants")
    if ibl_lights:
        doc_ext["EXT_lights_image_based"] = {"lights": ibl_lights}
    if doc_ext:
        gltf["extensions"] = doc_ext
    for name in used:  # merge — per-material/texture marks may already exist
        _mark_used(gltf, name)
    if not gltf.get("extensionsUsed"):
        gltf.pop("extensionsUsed", None)

    blob = bytes(buffers)
    if path.suffix == ".glb":
        gltf["buffers"] = [{"byteLength": len(blob)}] if blob else []
        js = json.dumps(gltf, separators=(",", ":")).encode()
        js += b" " * ((-len(js)) % 4)
        blob_p = blob + b"\x00" * ((-len(blob)) % 4)
        chunks = struct.pack("<II", len(js), 0x4E4F534A) + js
        if blob_p:
            chunks += struct.pack("<II", len(blob_p), 0x004E4942) + blob_p
        header = struct.pack("<III", 0x46546C67, 2, 12 + len(chunks))
        path.write_bytes(header + chunks)
    else:
        bin_path = path.with_suffix(".bin")
        if blob:
            bin_path.write_bytes(blob)
            gltf["buffers"] = [{"uri": bin_path.name, "byteLength": len(blob)}]
        else:
            gltf["buffers"] = []
        path.write_text(json.dumps(gltf, indent=1))


def _pil():
    """PIL's Image module, or an ImportError naming what needs it."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError("JPEG and WebP textures need PIL (the Pillow package); PNG and "
                          "uncompressed or zlib KTX2 textures do not") from err
    return Image


def _encode_webp(pixels) -> bytes:
    import io as _io

    img = _io.BytesIO()
    _pil().fromarray(np.asarray(pixels, np.uint8)).save(img, format="WEBP", lossless=True)
    return img.getvalue()


def _read_image(gltf, buffers, path: Path, image_index: int) -> np.ndarray:
    """Decode a glTF image (bufferView, file uri, or data uri) to (h, w, 4) uint8: PNG
    with zlib, KTX2 by `_decode_ktx2`, anything else (JPEG, WebP) with PIL."""
    import io as _io

    img = gltf.get("images", [])[image_index]
    if "bufferView" in img:
        bv = gltf["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        data = bytes(buffers[bv.get("buffer", 0)][off:off + bv["byteLength"]])
    else:
        uri = img.get("uri", "")
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            data = (path.parent / uri).read_bytes()
    if data[:12] == _KTX2_MAGIC:
        return _decode_ktx2(data)
    if data[:8] == _PNG_MAGIC:
        return decode_png(data)
    with _pil().open(_io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


_KTX2_MAGIC = b"\xabKTX 20\xbb\r\n\x1a\n"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

# VkFormat values this decoder maps straight to channel layouts.
_KTX2_FORMATS = {
    37: 4, 43: 4,  # R8G8B8A8_UNORM / _SRGB
    23: 3, 29: 3,  # R8G8B8_UNORM / _SRGB
}


def _decode_ktx2(data: bytes) -> np.ndarray:
    """KTX2 container decode for uncompressed R8G8B8(A8) payloads, with optional
    zstd supercompression (KHR_texture_basisu carrier; the reference transcodes
    basisu ETC1S/UASTC via the basisu library, src/render/Textures.cpp — GPU-block
    transcode targets don't apply to a CPU rasterizer, so compressed-basis payloads
    are a documented exception here)."""
    import struct

    (vk_format, type_size, w, h, depth, layers, faces, levels, scheme) = struct.unpack(
        "<IIIIIIIII", data[12:48])
    if vk_format not in _KTX2_FORMATS:
        raise ValueError(
            f"KTX2 vkFormat {vk_format} unsupported: this build decodes uncompressed "
            "RGB8/RGBA8 KTX2 (with zstd/zlib supercompression); basis-compressed "
            "ETC1S/UASTC payloads need the basisu transcoder, deliberately absent "
            "here — see ARCHITECTURE.md 'Known gaps' for the reason and the "
            "extension point (this function)")
    # Level index: levels * 3 u64 entries at offset 80.
    off, length, uncomp = struct.unpack("<QQQ", data[80:104])  # level 0
    payload = data[off:off + length]
    if scheme == 2:  # zstd supercompression
        try:
            import zstandard
        except ImportError as err:
            raise ImportError("zstd-supercompressed KTX2 textures need the zstandard "
                              "package") from err

        payload = zstandard.ZstdDecompressor().decompress(payload, max_output_size=uncomp)
    elif scheme == 3:  # zlib
        import zlib

        payload = zlib.decompress(payload)
    elif scheme != 0:
        raise ValueError(f"KTX2 supercompression scheme {scheme} unsupported")
    ch = _KTX2_FORMATS[vk_format]
    arr = np.frombuffer(payload, np.uint8)[: w * h * ch].reshape(h, w, ch)
    if ch == 3:
        arr = np.concatenate([arr, np.full((h, w, 1), 255, np.uint8)], axis=2)
    return arr.copy()


def _read_buffer(gltf, path: Path, blob: bytes | None) -> list[bytes]:
    out = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(blob or b"")
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            out.append((path.parent / uri).read_bytes())
    return out


_COMP_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
                5125: np.uint32, 5126: np.float32}
_TYPE_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}


def _read_view_elements(gltf, buffers, view_idx, byte_offset, comp, width, count):
    """Elements from a bufferView honoring byteStride (interleaved vertex buffers —
    common in third-party exporters, never produced by this one).

    EXT_meshopt_compression (reference table: README.md:118): the spec's fallback
    pattern is honored — the plain bufferView.buffer holds a byte-identical
    uncompressed fallback when the exporter provided one (gltfpack default), which
    this reads directly; a view whose only payload is the compressed stream (no
    fallback bytes) is rejected with a clear error instead of misread."""
    view = gltf["bufferViews"][view_idx]
    data = buffers[view.get("buffer", 0)]
    if (view.get("extensions") or {}).get("EXT_meshopt_compression"):
        needed = view.get("byteOffset", 0) + view.get(
            "byteLength", view.get("byteStride", 0) * count)
        if len(data) < needed:
            raise ValueError(
                "EXT_meshopt_compression bufferView carries no fallback payload; "
                "the meshopt codec itself is not implemented — re-export with a "
                "fallback buffer (gltfpack default) or decompress first")
    start = view.get("byteOffset", 0) + byte_offset
    itemsize = np.dtype(comp).itemsize
    natural = itemsize * width
    stride = view.get("byteStride", 0) or natural
    if stride == natural:
        arr = np.frombuffer(data, dtype=comp, count=count * width, offset=start)
        return arr.reshape(count, width)
    end = start + stride * (count - 1) + natural
    raw = np.frombuffer(data, np.uint8, count=end - start, offset=start)
    gather = np.arange(count)[:, None] * stride + np.arange(natural)[None, :]
    return raw[gather].copy().view(comp).reshape(count, width)


def _read_accessor(gltf, buffers, idx):
    """Accessor decode covering the ingestion surface third-party files use:
    all component types, interleaved byteStride views, `normalized` integer
    attributes, sparse accessors, and bufferView-less (zero-initialized) accessors
    (glTF 2.0 spec 3.6.2; the reference ingests these via fastgltf)."""
    acc = gltf["accessors"][idx]
    comp = _COMP_DTYPES[acc["componentType"]]
    width = _TYPE_WIDTH[acc["type"]]
    count = acc["count"]
    if "bufferView" in acc:
        arr = _read_view_elements(gltf, buffers, acc["bufferView"],
                                  acc.get("byteOffset", 0), comp, width, count).copy()
    else:
        arr = np.zeros((count, width), comp)
    sp = acc.get("sparse")
    if sp:
        si = sp["indices"]
        icomp = _COMP_DTYPES[si["componentType"]]
        rows = _read_view_elements(gltf, buffers, si["bufferView"],
                                   si.get("byteOffset", 0), icomp, 1,
                                   sp["count"]).reshape(-1).astype(np.int64)
        sv = sp["values"]
        vals = _read_view_elements(gltf, buffers, sv["bufferView"],
                                   sv.get("byteOffset", 0), comp, width, sp["count"])
        arr[rows] = vals
    if acc.get("normalized") and comp != np.float32:
        info = np.iinfo(comp)
        arr = arr.astype(np.float32) / float(info.max)
        if info.min < 0:
            arr = np.maximum(arr, -1.0)
    return arr if width > 1 else arr.reshape(-1)


def _import_audio_ext(gltf, buffers):
    """Parse the document-level KHR_audio_rigid_bodies extension with the reference's
    validation (GltfScene.cpp:2415-2508): invalid material fields fall back to the
    engine default with a warning; a model with mismatched accessors, a non-positive
    frequency, a negative decay rate, or any non-finite value reads back as None (the
    list stays index-aligned with the document)."""
    import sys

    from ..types import ModalModes

    ext = (gltf.get("extensions") or {}).get("KHR_audio_rigid_bodies")
    if not ext:
        return [], []

    # Engine default = the first preset (Ceramic), the reference's fallback.
    defaults = {"density": 2700.0, "youngsModulus": 7.2e10, "poissonRatio": 0.19,
                "alpha": 6.0, "beta": 1e-7}
    checks = {"density": lambda v: v > 0, "youngsModulus": lambda v: v > 0,
              "poissonRatio": lambda v: -1 < v < 0.5,
              "alpha": lambda v: v >= 0, "beta": lambda v: v >= 0}
    materials = []
    for m in ext.get("acousticMaterials", []):
        name = m.get("name", "")
        vals = {}
        for key, fb in defaults.items():
            v = m.get(key, fb)
            if not (np.isfinite(v) and checks[key](v)):
                print(f"Warning: KHR_audio_rigid_bodies acoustic material {name!r} has "
                      f"an invalid {key} ({v}); using {fb}.", file=sys.stderr)
                v = fb
            vals[key] = float(v)
        materials.append(AcousticMaterialRef(
            name=name, density=vals["density"], young_modulus=vals["youngsModulus"],
            poisson_ratio=vals["poissonRatio"], alpha=vals["alpha"], beta=vals["beta"],
        ))

    def read_model(m):
        try:
            freqs = np.asarray(_read_accessor(gltf, buffers, m["frequencies"]),
                               np.float64).reshape(-1)
            decay = np.asarray(_read_accessor(gltf, buffers, m["decayRates"]),
                               np.float64).reshape(-1)
            positions = np.asarray(_read_accessor(gltf, buffers, m["positions"]),
                                   np.float64).reshape(-1, 3)
            shapes_km = np.asarray(_read_accessor(gltf, buffers, m["shapes"]),
                                   np.float64).reshape(-1, 3)
        except (KeyError, IndexError):
            return None
        k, p = freqs.size, positions.shape[0]
        if k == 0 or p == 0 or decay.size != k or shapes_km.shape[0] != k * p:
            return None
        finite = all(np.isfinite(a).all() for a in (freqs, decay, positions, shapes_km))
        if not finite or (freqs <= 0).any() or (decay < 0).any():
            return None
        t60s = np.where(decay > 0, _LN1000 / np.maximum(decay, 1e-300), 0.0)
        shapes = shapes_km.reshape(k, p, 3).transpose(1, 0, 2)  # wire is mode-major
        indices = np.zeros(0, np.uint32)
        if "indices" in m:
            tris = np.asarray(_read_accessor(gltf, buffers, m["indices"]),
                              np.uint32).reshape(-1)
            if tris.size % 3 == 0 and (tris < p).all():
                indices = tris
            else:
                print(f"Warning: KHR_audio_rigid_bodies modal model "
                      f"{m.get('name', '')!r} has sample surface indices outside its "
                      f"sample points; ignoring them.", file=sys.stderr)
        modes = ModalModes(freqs=freqs, t60s=t60s, shapes=shapes, positions=positions,
                           indices=indices, original_fundamental_freq=float(freqs[0]))
        return modes, m.get("material"), m.get("massProperties")

    models = []
    for m in ext.get("modalModels", []):
        model = read_model(m)
        if model is None:
            print(f"Warning: KHR_audio_rigid_bodies modal model {m.get('name', '')!r} "
                  f"has accessors that do not match, or a frequency at or below zero, "
                  f"or a negative decay rate; ignoring it.", file=sys.stderr)
        models.append(model)
    return materials, models


def import_gltf(path, store_dir=None) -> Registry:
    """Load a .gltf/.glb into a fresh scene Registry. With `store_dir`, embedded
    KHR_audio_rigid_bodies modal models are saved into the content-addressed store and
    bound to their nodes with a current-inputs fingerprint, so SceneAudio.reconcile
    plays them without re-solving."""
    path = Path(path)
    blob = None
    if path.suffix == ".glb":
        raw = path.read_bytes()
        magic, version, _ = struct.unpack_from("<III", raw, 0)
        assert magic == 0x46546C67, "not a GLB"
        off = 12
        gltf = None
        while off < len(raw):
            clen, ctype = struct.unpack_from("<II", raw, off)
            data = raw[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:
                gltf = json.loads(data)
            elif ctype == 0x004E4942:
                blob = data
            off += 8 + clen
    else:
        gltf = json.loads(path.read_text())
    buffers = _read_buffer(gltf, path, blob)

    r = Registry()
    # Imported scenes come wired with the standard derivation pipeline, so
    # r.process() derives world transforms / skinning without extra setup.
    from ..scene.derive import install_default_pipeline

    install_default_pipeline(r)
    audio_materials, audio_models = _import_audio_ext(gltf, buffers)
    implicit_shapes = ((gltf.get("extensions") or {}).get("KHR_implicit_shapes") or {}) \
        .get("shapes", [])
    doc_variants = [v.get("name", f"variant{i}") for i, v in enumerate(
        ((gltf.get("extensions") or {}).get("KHR_materials_variants") or {})
        .get("variants", []))]
    node_entity: dict[int, int] = {}
    for ni, node in enumerate(gltf.get("nodes", [])):
        e = r.create()
        node_entity[ni] = e
        r.emplace(e, Name(node.get("name", "")))
        r.emplace(e, SceneNode())
        tr = Transform()
        if "translation" in node:
            tr.translation = np.asarray(node["translation"], np.float64)
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            tr.rotation = np.asarray([w, x, y, z], np.float64)
        if "scale" in node:
            tr.scale = np.asarray(node["scale"], np.float64)
        r.emplace(e, tr)
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            prim = mesh["primitives"][0]
            pos = _read_accessor(gltf, buffers, prim["attributes"]["POSITION"]).astype(np.float64)
            if "indices" in prim:
                idx = _read_accessor(gltf, buffers, prim["indices"]).astype(np.uint32)
            else:
                idx = np.arange(pos.shape[0], dtype=np.uint32)
            targets = np.zeros((0, 0, 3))
            if prim.get("targets"):
                deltas = [
                    np.asarray(_read_accessor(gltf, buffers, t["POSITION"]), np.float64)
                    for t in prim["targets"] if "POSITION" in t
                ]
                if deltas:
                    targets = np.stack(deltas)
            weights = np.asarray(mesh.get("weights", node.get("weights", [])), np.float64)
            uv_attr = prim["attributes"].get("TEXCOORD_0")
            uvs = (_read_accessor(gltf, buffers, uv_attr).astype(np.float64)
                   if uv_attr is not None else np.zeros((0, 2)))
            r.emplace(e, MeshSurface(positions=pos, triangles=idx.reshape(-1, 3),
                                     morph_targets=targets, morph_weights=weights,
                                     uvs=uvs))
            if "material" in prim:
                m = gltf.get("materials", [])[prim["material"]]
                pbr = m.get("pbrMetallicRoughness", {})
                uv_transform = np.array([0.0, 0.0, 0.0, 1.0, 1.0])

                def _load_tex(info, kind):
                    nonlocal uv_transform
                    if info is None or "index" not in info:
                        return np.zeros((0, 0, 4), np.uint8)
                    tt = (info.get("extensions") or {}).get("KHR_texture_transform")
                    if tt:
                        off = tt.get("offset", [0.0, 0.0])
                        sc = tt.get("scale", [1.0, 1.0])
                        uv_transform = np.array([off[0], off[1],
                                                 tt.get("rotation", 0.0), sc[0], sc[1]])
                    try:
                        tex_entry = gltf.get("textures", [])[info["index"]]
                        tex_ext = tex_entry.get("extensions") or {}
                        # Extension sources take priority (they carry the real
                        # payload; core `source` is the fallback when present).
                        src = (tex_ext.get("EXT_texture_webp") or {}).get("source")
                        if src is None:  # KHR_texture_basisu carries KTX2 sources
                            src = (tex_ext.get("KHR_texture_basisu") or {}).get("source")
                        if src is None:
                            src = tex_entry.get("source")
                        if src is not None:
                            return _read_image(gltf, buffers, path, src)
                    except ImportError:
                        raise  # a missing decoder never drops a texture
                    except Exception as exc:  # undecodable payloads degrade gracefully
                        print(f"Warning: {kind} decode failed: {exc}")
                    return np.zeros((0, 0, 4), np.uint8)

                texture = _load_tex(pbr.get("baseColorTexture"), "baseColorTexture")
                mr_texture = _load_tex(pbr.get("metallicRoughnessTexture"),
                                       "metallicRoughnessTexture")
                emissive_texture = _load_tex(m.get("emissiveTexture"),
                                             "emissiveTexture")
                normal_texture = _load_tex(m.get("normalTexture"), "normalTexture")
                occlusion_texture = _load_tex(m.get("occlusionTexture"),
                                              "occlusionTexture")
                vm_kwargs = dict(
                    base_color=np.asarray(
                        pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]), np.float64),
                    metallic=float(pbr.get("metallicFactor", 1.0)),
                    roughness=float(pbr.get("roughnessFactor", 1.0)),
                    emissive=np.asarray(m.get("emissiveFactor", [0.0, 0.0, 0.0]),
                                        np.float64),
                    double_sided=bool(m.get("doubleSided", False)),
                    texture=texture,
                    mr_texture=mr_texture,
                    emissive_texture=emissive_texture,
                    normal_texture=normal_texture,
                    occlusion_texture=occlusion_texture,
                    uv_transform=uv_transform,
                    alpha_mode=m.get("alphaMode", "OPAQUE"),
                    alpha_cutoff=float(m.get("alphaCutoff", 0.5)),
                )
                _import_material_extensions(m, vm_kwargs)
                r.emplace(e, VisualMaterial(**vm_kwargs))
            pv = (prim.get("extensions") or {}).get("KHR_materials_variants")
            if pv and doc_variants:
                mappings = []
                for mp in pv.get("mappings", []):
                    mi = mp.get("material")
                    if mi is None or not (0 <= mi < len(gltf.get("materials", []))):
                        continue
                    mappings.append({
                        "variants": [int(v) for v in mp.get("variants", [])],
                        "material": _strip_texture_refs(gltf["materials"][mi]),
                    })
                if mappings:
                    from ..scene.components import MaterialVariants

                    r.emplace(e, MaterialVariants(names=list(doc_variants),
                                                  mappings=mappings))
        extras = node.get("extras", {})
        ac = extras.get("MESHEDITOR_TPU_acoustic")
        if ac:
            r.emplace(e, AcousticMaterialRef(
                ac.get("name", "Ceramic"), ac["density"], ac["youngModulus"],
                ac["poissonRatio"], ac.get("alpha", 0.0), ac.get("beta", 0.0)))
        ss = extras.get("MESHEDITOR_TPU_solve")
        if ss:
            r.emplace(e, SolveSettingsComponent(
                num_vertices=ss.get("numVertices", 10),
                solve_resolution=ss.get("solveResolution", 1.0),
                num_modes=ss.get("numModes", 30),
                min_mode_freq=ss.get("minModeFreq", 20.0),
                max_mode_freq=ss.get("maxModeFreq", 16000.0)))
        mm = extras.get("MESHEDITOR_TPU_modal")
        if mm:
            r.emplace(e, ModalModel(mm["path"]))

        lref = (node.get("extensions") or {}).get("KHR_lights_punctual")
        if lref is not None:
            doc_lights = ((gltf.get("extensions") or {}).get("KHR_lights_punctual")
                          or {}).get("lights", [])
            li = lref.get("light", -1)
            if 0 <= li < len(doc_lights):
                ld = doc_lights[li]
                spot = ld.get("spot", {})
                r.emplace(e, LightComponent(
                    kind=ld.get("type", "directional"),
                    color=np.asarray(ld.get("color", [1.0, 1.0, 1.0]), np.float64),
                    intensity=float(ld.get("intensity", 1.0)),
                    range=float(ld.get("range", 0.0)),
                    inner_cone_angle=float(spot.get("innerConeAngle", 0.0)),
                    outer_cone_angle=float(spot.get("outerConeAngle", np.pi / 4)),
                ))

        vext = (node.get("extensions") or {}).get("KHR_node_visibility")
        if vext is not None:
            r.emplace(e, VisibilityComponent(visible=bool(vext.get("visible", True))))

        iblref = (node.get("extensions") or {}).get("EXT_lights_image_based")
        if iblref is not None:
            doc_ibl = ((gltf.get("extensions") or {}).get("EXT_lights_image_based")
                       or {}).get("lights", [])
            li = iblref.get("light", -1)
            if 0 <= li < len(doc_ibl):
                from ..render.environment import (
                    equirect_from_cube_faces, equirect_from_sh9,
                )
                from ..render.shading import srgb_to_linear
                from ..scene.components import ImageBasedLightComponent

                entry = doc_ibl[li]
                spec = entry.get("specularImages") or []
                equirect = np.zeros((0, 0, 3), np.float32)
                if spec and len(spec[0]) == 6:
                    faces = np.stack([
                        srgb_to_linear(
                            _read_image(gltf, buffers, path, fi)[..., :3]
                            .astype(np.float32) / 255.0)
                        for fi in spec[0]])
                    equirect = equirect_from_cube_faces(faces, faces.shape[1])
                elif entry.get("irradianceCoefficients"):
                    equirect = equirect_from_sh9(
                        np.asarray(entry["irradianceCoefficients"], np.float64))
                x, y, z, w = entry.get("rotation", [0.0, 0.0, 0.0, 1.0])
                r.emplace(e, ImageBasedLightComponent(
                    equirect=equirect,
                    intensity=float(entry.get("intensity", 1.0)),
                    rotation=np.asarray([w, x, y, z], np.float64),
                ))

        # EXT_mesh_gpu_instancing: per-instance TRS attribute accessors. Imported as
        # child entities carrying the mesh (the reference "imports into MeshEditor
        # instances", README.md:93-119); the carrier node keeps no mesh of its own.
        iext = (node.get("extensions") or {}).get("EXT_mesh_gpu_instancing")
        if iext is not None and r.has(e, MeshSurface):
            attrs = iext.get("attributes") or {}
            tr_acc = attrs.get("TRANSLATION")
            rot_acc = attrs.get("ROTATION")
            sc_acc = attrs.get("SCALE")
            counts = [gltf["accessors"][a]["count"]
                      for a in (tr_acc, rot_acc, sc_acc) if a is not None]
            n_inst = min(counts) if counts else 0
            if n_inst:
                t_arr = (_read_accessor(gltf, buffers, tr_acc).astype(np.float64)
                         if tr_acc is not None else np.zeros((n_inst, 3)))
                q_arr = (_read_accessor(gltf, buffers, rot_acc).astype(np.float64)
                         if rot_acc is not None
                         else np.tile([0.0, 0.0, 0.0, 1.0], (n_inst, 1)))
                s_arr = (_read_accessor(gltf, buffers, sc_acc).astype(np.float64)
                         if sc_acc is not None else np.ones((n_inst, 3)))
                surf = r.get(e, MeshSurface)
                mat_comp = r.get(e, VisualMaterial)
                base_name = node.get("name", "")
                for i in range(n_inst):
                    ce = r.create()
                    r.emplace(ce, Name(f"{base_name}.instance{i}"))
                    r.emplace(ce, SceneNode(parent=e))
                    x, y, z, w_ = q_arr[i]
                    it = Transform()
                    it.translation = t_arr[i].copy()
                    it.rotation = np.asarray([w_, x, y, z], np.float64)
                    it.scale = s_arr[i].copy()
                    r.emplace(ce, it)
                    r.emplace(ce, MeshSurface(
                        positions=np.asarray(surf.positions).copy(),
                        triangles=np.asarray(surf.triangles).copy(),
                        morph_targets=np.asarray(surf.morph_targets).copy(),
                        morph_weights=np.asarray(surf.morph_weights).copy(),
                        uvs=np.asarray(surf.uvs).copy()))
                    if mat_comp is not None:
                        import copy as _copy

                        r.emplace(ce, _copy.deepcopy(mat_comp))
                r.remove(e, MeshSurface)

        pext = (node.get("extensions") or {}).get("KHR_physics_rigid_bodies")
        if pext is not None:
            rb = RigidBodyComponent()
            geom = (pext.get("collider") or {}).get("geometry") or {}
            si = geom.get("shape")
            if "node" in geom:
                # Node-geometry collider: the node's own mesh, optionally hulled.
                rb.shape_kind = "convex" if geom.get("convexHull") else "mesh"
            elif si is not None and 0 <= si < len(implicit_shapes):
                s = implicit_shapes[si]
                kind = s.get("type", "sphere")
                if kind == "box":
                    size = s.get("box", {}).get("size", [1.0, 1.0, 1.0])
                    rb.shape_kind = "box"
                    rb.half_extents = np.asarray(size, np.float64) / 2.0
                elif kind in ("capsule", "cylinder"):
                    c = s.get(kind, {})
                    rb.shape_kind = kind
                    rb.radius = float(c.get("radiusBottom", c.get("radiusTop", 0.5)))
                    rb.half_height = float(c.get("height", 1.0)) / 2.0
                elif kind == "plane":
                    p = s.get("plane", {})
                    rb.shape_kind = "plane"
                    rb.plane_normal = np.asarray(p.get("normal", [0, 1, 0]), np.float64)
                    rb.plane_offset = float(p.get("offset", 0.0))
                else:
                    rb.shape_kind = "sphere"
                    rb.radius = float(s.get("sphere", {}).get("radius", 0.5))
            motion = pext.get("motion")
            if motion is not None:
                rb.is_dynamic = not motion.get("isKinematic", False)
                rb.is_kinematic = bool(motion.get("isKinematic", False))
                rb.mass = float(motion.get("mass", 0.0))
                rb.gravity_factor = float(motion.get("gravityFactor", 1.0))
                rb.linear_velocity = np.asarray(motion.get("linearVelocity", [0, 0, 0]),
                                                np.float64)
                rb.angular_velocity = np.asarray(motion.get("angularVelocity", [0, 0, 0]),
                                                 np.float64)
            r.emplace(e, rb)

        aext = (node.get("extensions") or {}).get("KHR_audio_rigid_bodies")
        model = None
        if aext is not None:
            mi = aext.get("modalModel")
            if mi is not None and 0 <= mi < len(audio_models):
                model = audio_models[mi]
        if model is not None:
            modes, mat_i, massp = model
            if not r.has(e, AcousticMaterialRef) and mat_i is not None \
                    and 0 <= mat_i < len(audio_materials):
                src = audio_materials[mat_i]
                r.emplace(e, AcousticMaterialRef(
                    src.name, src.density, src.young_modulus, src.poisson_ratio,
                    src.alpha, src.beta))
            if "gain" in aext:
                r.emplace(e, ModalGainComponent(value=float(aext["gain"])))
            if store_dir is not None:
                from ..solve.orchestration import hash_solve_inputs
                from ..types import MassProperties
                from .model_store import save_modal_model

                mass = MassProperties()
                if massp:
                    x, y, z, w = massp.get("inertiaOrientation", [0, 0, 0, 1])
                    mass = MassProperties(
                        mass=float(massp.get("mass", 0.0)),
                        center_of_mass=np.asarray(massp.get("centerOfMass", [0, 0, 0]),
                                                  np.float64),
                        inertia_diagonal=np.asarray(
                            massp.get("inertiaDiagonal", [0, 0, 0]), np.float64),
                        inertia_orientation=np.asarray([w, x, y, z], np.float64),
                    )
                saved = save_modal_model(store_dir, modes, mass)
                # Stamp the fingerprint SceneAudio.reconcile would compute for this
                # node's current inputs, so the embedded model plays without a solve.
                surf = r.get(e, MeshSurface)
                s = r.get(e, SolveSettingsComponent) or SolveSettingsComponent()
                mat = r.get(e, AcousticMaterialRef) or AcousticMaterialRef()
                tr_ = r.get(e, Transform)
                scale = np.asarray(tr_.scale, np.float64) if tr_ else np.ones(3)
                ih = hash_solve_inputs(
                    np.asarray(surf.positions, np.float64),
                    np.asarray(surf.triangles, np.int64),
                    np.zeros((0, 3)), scale, s.quality_tets, s.solve_resolution,
                ) if surf is not None else ""
                r.emplace(e, ModalModel(
                    path=str(saved), inputs_hash=ih, num_modes=s.num_modes,
                    min_mode_freq=s.min_mode_freq, max_mode_freq=s.max_mode_freq,
                    poisson_ratio=mat.poisson_ratio,
                ))
    for ni, node in enumerate(gltf.get("nodes", [])):
        for child in node.get("children", []):
            sn = r.get(node_entity[child], SceneNode)
            sn.parent = node_entity[ni]
            r.emplace(node_entity[child], sn)

    # Animations -> one clip-carrying entity per document animation.
    from ..scene.animation import (
        AnimationChannel, AnimationClip, AnimationClipComponent, Interpolation,
        TargetPath,
    )

    for anim in gltf.get("animations", []):
        channels = []
        for ch in anim.get("channels", []):
            smp = anim["samplers"][ch["sampler"]]
            target = ch.get("target", {})
            ni = target.get("node")
            path = target.get("path")
            if ni is None or ni not in node_entity or path is None:
                continue
            times = _read_accessor(gltf, buffers, smp["input"]).astype(np.float64)
            vals = _read_accessor(gltf, buffers, smp["output"]).astype(np.float64)
            interp = Interpolation(smp.get("interpolation", "LINEAR"))
            tp = TargetPath(path)
            if tp == TargetPath.WEIGHTS:
                k = times.shape[0]
                per = (3 * k) if interp == Interpolation.CUBICSPLINE else k
                m = max(vals.size // per, 1)
                vals = vals.reshape(-1, m)
            if vals.ndim == 1:
                vals = vals.reshape(times.shape[0], -1)
            if tp == TargetPath.ROTATION:
                vals = vals[:, [3, 0, 1, 2]]  # xyzw -> wxyz
            if interp == Interpolation.CUBICSPLINE:
                vals = vals.reshape(times.shape[0], 3, -1)
            channels.append(AnimationChannel(
                entity=node_entity[ni], path=tp, times=times, values=vals,
                interpolation=interp))
        if channels:
            ae = r.create()
            r.emplace(ae, AnimationClipComponent(
                clip=AnimationClip(anim.get("name", ""), channels)))

    r.drain_events()
    return r
