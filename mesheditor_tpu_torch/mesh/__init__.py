from .primitives import (
    bar_tets,
    bowl_surface,
    box_tets,
    circle_surface,
    cone_surface,
    cuboid_surface,
    cylinder_surface,
    grid_box_surface,
    icosphere_surface,
    plane_surface,
    shell_surface,
    torus_surface,
    uv_sphere_surface,
)
from .obj_io import load_obj, save_obj
from .ply_io import load_ply, save_ply

__all__ = [
    "bar_tets",
    "bowl_surface",
    "shell_surface",
    "box_tets",
    "cuboid_surface",
    "cylinder_surface",
    "grid_box_surface",
    "icosphere_surface",
    "plane_surface",
    "torus_surface",
    "uv_sphere_surface",
    "circle_surface",
    "cone_surface",
    "load_obj",
    "save_obj",
    "load_ply",
    "save_ply",
]
