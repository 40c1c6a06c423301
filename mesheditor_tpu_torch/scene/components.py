"""Scene components and the Persistent/Derived role table.

Every live component type must be registered as Persistent (snapshotted/replayed) or
Derived (rebuilt by the frame pipeline) — the coverage rule the reference enforces with
VerifyCoverage (src/snapshot/SnapshotRoles.h:11-36), which is what keeps replay
byte-exact: anything unclassified is a determinism hole.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Name:
    value: str = ""


@dataclass
class SceneNode:
    """Intrusive scene-graph link (reference: src/scene/SceneGraph.h:6-10)."""

    parent: int = 0  # 0 = root


@dataclass
class Transform:
    """Local TRS."""

    translation: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))  # wxyz
    scale: np.ndarray = field(default_factory=lambda: np.ones(3))


@dataclass
class WorldTransform:
    """Derived: parent-composed transform (reference: src/scene/WorldTransform.h:6-10)."""

    matrix: np.ndarray = field(default_factory=lambda: np.eye(4))


@dataclass
class MeshSurface:
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    triangles: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint32))
    # glTF morph targets: (m, n, 3) POSITION deltas + the current weights (m,).
    morph_targets: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 3)))
    morph_weights: np.ndarray = field(default_factory=lambda: np.zeros(0))
    # glTF TEXCOORD_0 (n, 2); empty when the mesh is untextured.
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))

    def morphed_positions(self) -> np.ndarray:
        """Base positions plus the weighted morph deltas (glTF 2.0 morph semantics)."""
        if self.morph_targets.shape[0] == 0 or self.morph_weights.shape[0] == 0:
            return self.positions
        w = self.morph_weights[: self.morph_targets.shape[0]]
        return self.positions + np.einsum("m,mnk->nk", w, self.morph_targets)


@dataclass
class AcousticMaterialRef:
    name: str = "Ceramic"
    density: float = 2700.0
    young_modulus: float = 7.2e10
    poisson_ratio: float = 0.19
    alpha: float = 6.0
    beta: float = 1e-7


@dataclass
class SolveSettingsComponent:
    num_vertices: int = 10
    solve_resolution: float = 1.0
    quality_tets: bool = False
    num_modes: int = 30
    min_mode_freq: float = 20.0
    max_mode_freq: float = 16_000.0


@dataclass
class ModalModel:
    """A solved (or loaded) modal model bound to the object; `path` is the
    content-addressed artifact so replay is deterministic
    (reference: ApplyModalModel + ModalModelFile, src/audio/ModalModelFile.cpp:26-48).
    The solve fingerprint rides along so a reloaded scene can tell whether the model
    still answers the current inputs without re-solving (ModalModelStale,
    AudioSystem.cpp:1080-1090)."""

    path: str = ""
    inputs_hash: str = ""
    num_modes: int = 0
    min_mode_freq: float = 0.0
    max_mode_freq: float = 0.0
    poisson_ratio: float = 0.0


@dataclass
class ModalGainComponent:
    value: float = 1.0


@dataclass
class ModalTuningComponent:
    fundamental_freq: float = 0.0
    t60_scale: float = 1.0


@dataclass
class SoundVertices:
    """Excitable vertex selection + playback model (reference: src/audio/SoundVertices.h,
    SoundVerticesModel::{Samples, Modal} at AudioTypes.h:39-46 — Samples taps recorded
    clips at the struck vertex for ground-truth A/B against the modal render)."""

    vertices: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    model: str = "modal"  # modal | samples


@dataclass
class RigidBodyComponent:
    """KHR_physics_rigid_bodies node payload: an implicit collider shape plus motion
    (reference: PhysicsRigidBody import, GltfScene.cpp:1743-1775). Flat so snapshots
    and the glTF roundtrip stay field-for-field. A body with no motion (is_dynamic
    False) is static; mass <= 0 derives from shape volume."""

    # sphere | box | capsule | cylinder | plane | mesh | convex
    # (mesh/convex use the entity's MeshSurface; convex takes its convex hull)
    shape_kind: str = "sphere"
    radius: float = 0.5
    half_height: float = 0.5  # capsule/cylinder half-height along local Y
    half_extents: np.ndarray = field(default_factory=lambda: np.full(3, 0.5))
    plane_normal: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    plane_offset: float = 0.0
    is_dynamic: bool = False
    is_kinematic: bool = False
    mass: float = 0.0
    gravity_factor: float = 1.0
    linear_velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))
    angular_velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class VisualMaterial:
    """glTF pbrMetallicRoughness factors for the renderer (reference: PBR material
    model, README.md:85-88; GltfScene material import/export)."""

    base_color: np.ndarray = field(default_factory=lambda: np.array([0.48, 0.65, 0.76, 1.0]))
    metallic: float = 0.2
    roughness: float = 0.7
    emissive: np.ndarray = field(default_factory=lambda: np.zeros(3))
    double_sided: bool = True
    # baseColorTexture payload: (h, w, 4) uint8 sRGB; empty = untextured.
    texture: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 4), np.uint8))
    # metallicRoughnessTexture: (h, w, 4) uint8 LINEAR; G = roughness, B = metallic
    # (the glTF ORM channel layout). Factors multiply the sampled values.
    mr_texture: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 4), np.uint8))
    # emissiveTexture: (h, w, 4) uint8 sRGB, multiplied by `emissive`.
    emissive_texture: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 4), np.uint8))
    # normalTexture: (h, w, 4) uint8 tangent-space, +Z out (OpenGL convention).
    normal_texture: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 4), np.uint8))
    # occlusionTexture R channel scales ambient/environment light.
    occlusion_texture: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 4), np.uint8))
    # KHR_texture_transform on TEXCOORD_0, applied to every texture of this material:
    # [offset_u, offset_v, rotation_rad, scale_u, scale_v].
    uv_transform: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0, 1.0]))
    # --- KHR_materials_* extension factors (reference supports the full set,
    # MeshEditor's README.md:93-119; shaded subset mirrors the reference's
    # glTF-Sample-Renderer BRDF terms, the rest roundtrips losslessly) ---
    emissive_strength: float = 1.0      # KHR_materials_emissive_strength
    unlit: bool = False                 # KHR_materials_unlit
    ior: float = 1.5                    # KHR_materials_ior
    specular: float = 1.0               # KHR_materials_specular specularFactor
    specular_color: np.ndarray = field(default_factory=lambda: np.ones(3))
    clearcoat: float = 0.0              # KHR_materials_clearcoat
    clearcoat_roughness: float = 0.0
    sheen_color: np.ndarray = field(default_factory=lambda: np.zeros(3))
    sheen_roughness: float = 0.0        # KHR_materials_sheen
    transmission: float = 0.0           # KHR_materials_transmission
    diffuse_transmission: float = 0.0   # KHR_materials_diffuse_transmission
    diffuse_transmission_color: np.ndarray = field(default_factory=lambda: np.ones(3))
    thickness: float = 0.0              # KHR_materials_volume
    attenuation_distance: float = 0.0   # 0 = unbounded (the spec's +inf default)
    attenuation_color: np.ndarray = field(default_factory=lambda: np.ones(3))
    dispersion: float = 0.0             # KHR_materials_dispersion
    anisotropy_strength: float = 0.0    # KHR_materials_anisotropy
    anisotropy_rotation: float = 0.0
    iridescence: float = 0.0            # KHR_materials_iridescence
    iridescence_ior: float = 1.3
    iridescence_thickness_min: float = 100.0
    iridescence_thickness_max: float = 400.0
    # Core-glTF alpha coverage (roundtrip; the deferred G-buffer keeps opaque depth).
    alpha_mode: str = "OPAQUE"          # OPAQUE | MASK | BLEND
    alpha_cutoff: float = 0.5


@dataclass
class LightComponent:
    """KHR_lights_punctual node payload (reference imports the extension,
    README.md:93-119). Direction is the node's -Z in world after transforms; stored
    here explicitly so headless scenes can set it without a node graph."""

    kind: str = "directional"  # directional | point | spot
    color: np.ndarray = field(default_factory=lambda: np.ones(3))
    intensity: float = 1.0
    range: float = 0.0  # 0 = unlimited
    inner_cone_angle: float = 0.0
    outer_cone_angle: float = np.pi / 4


@dataclass
class ImageBasedLightComponent:
    """EXT_lights_image_based payload: the scene's image-based environment light
    (the reference imports it as Scene IBL, README.md:93-119). Stored natively as an
    equirect LINEAR radiance map; glTF IO resamples to/from the extension's cubemap +
    SH9 wire format (render/environment.py converters)."""

    equirect: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 3), np.float32))
    intensity: float = 1.0
    rotation: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))


@dataclass
class MaterialVariants:
    """KHR_materials_variants payload: the document's variant name list plus this
    primitive's mappings, each a JSON-safe glTF material dict (factors + material
    extensions; texture references are document-local and do not travel). Switch with
    io.gltf.apply_variant(registry, name) — it rewrites the active VisualMaterial's
    factor fields in place (reference supports the extension, README.md:93-119)."""

    names: list = field(default_factory=list)
    # [{"variants": [index...], "material": {<glTF material JSON, factors only>}}]
    mappings: list = field(default_factory=list)


@dataclass
class VisibilityComponent:
    """KHR_node_visibility payload (the reference loads/roundtrips it,
    README.md:93-119). Visibility INHERITS: a hidden parent hides the subtree — same
    caveat as the reference ("parent invisible, children visible" is inexpressible)."""

    visible: bool = True


@dataclass
class ExciteState:
    """Derived: live synth bookkeeping (bank slot etc.); rebuilt, never snapshotted."""

    bank_slot: int = -1


PERSISTENT_COMPONENTS = (
    Name,
    SceneNode,
    Transform,
    MeshSurface,
    AcousticMaterialRef,
    SolveSettingsComponent,
    ModalModel,
    ModalGainComponent,
    ModalTuningComponent,
    SoundVertices,
    RigidBodyComponent,
    VisualMaterial,
    LightComponent,
    VisibilityComponent,
    MaterialVariants,
    ImageBasedLightComponent,
)
DERIVED_COMPONENTS = (WorldTransform, ExciteState)


def _register_animation_components():
    global PERSISTENT_COMPONENTS
    from .animation import AnimationClipComponent

    PERSISTENT_COMPONENTS = PERSISTENT_COMPONENTS + (AnimationClipComponent,)


def _register_armature_components():
    """Armature/skinning components live in scene.armature (they carry their own
    math); registered here so the snapshot coverage rule sees them."""
    global PERSISTENT_COMPONENTS, DERIVED_COMPONENTS
    from .armature import ArmatureComponent, DeformedSurface, SkinComponent

    PERSISTENT_COMPONENTS = PERSISTENT_COMPONENTS + (ArmatureComponent, SkinComponent)
    DERIVED_COMPONENTS = DERIVED_COMPONENTS + (DeformedSurface,)


_register_animation_components()
_register_armature_components()
