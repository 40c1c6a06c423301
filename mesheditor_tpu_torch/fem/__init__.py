from .quad_basis import EDGE_CORNERS, NUM_QUAD_NODES, quad_basis
from .quad_mesh import QuadMesh, build_quad_mesh
from .assembly import (
    ElementOperators,
    ShiftedElementOperator,
    assemble_element_matrices,
    filter_degenerate,
    pencil_diagonals,
)
from .mass_properties import compute_mass_properties

__all__ = [
    "EDGE_CORNERS",
    "NUM_QUAD_NODES",
    "quad_basis",
    "QuadMesh",
    "build_quad_mesh",
    "ElementOperators",
    "ShiftedElementOperator",
    "assemble_element_matrices",
    "filter_degenerate",
    "pencil_diagonals",
    "compute_mass_properties",
]
