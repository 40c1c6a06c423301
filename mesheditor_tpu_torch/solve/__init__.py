from .lobpcg import LobpcgResult, lobpcg_pencil
from .mesh2modes import ModalResult, SolveReuse, mesh2modes
from .postprocess import postprocess_modes, rescale_modes

__all__ = [
    "LobpcgResult",
    "lobpcg_pencil",
    "ModalResult",
    "SolveReuse",
    "mesh2modes",
    "postprocess_modes",
    "rescale_modes",
]
