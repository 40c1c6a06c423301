"""Offscreen renderer in PyTorch (counterpart of mesheditor_tpu/render; reference:
src/render/, src/viewport/, src/selection/).

The reference renders with a bindless Vulkan pipeline and resolves mouse picking with GPU
compute passes. Here the pipeline runs as PyTorch on the device the caller names ("cuda"
by default; "cpu" runs the same ops on the host): a z-buffered triangle rasterizer
(`raster.py`) produces a G-buffer (depth, triangle id, barycentrics), a deferred shading
pass (`shading.py`) lights it with metallic-roughness PBR, punctual lights and prefiltered
image-based light (`environment.py`), and picking/box-selection (`picking.py`) read the
same ID buffers the reference's ObjectPick/ElementPick/BoxSelect.comp shaders write
(src/selection/SelectionGpu.h:75-81) — no CPU-side acceleration structures.
"""

from .camera import Camera, look_at, orbit_camera, perspective, view_projection
from .picking import box_select, box_select_vertices, pick_element, pick_object
from .raster import GBuffer, rasterize
from .scene_render import RenderSettings, render_scene, render_mesh, save_png
from .shading import LightBank, MaterialTable, shade

__all__ = [
    "Camera", "look_at", "orbit_camera", "perspective", "view_projection",
    "GBuffer", "rasterize", "MaterialTable", "LightBank", "shade",
    "pick_object", "pick_element", "box_select", "box_select_vertices",
    "RenderSettings", "render_scene", "render_mesh", "save_png",
]
