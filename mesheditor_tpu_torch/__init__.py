"""mesheditor_tpu_torch — the PyTorch/CUDA port of mesheditor_tpu's modal-audio pipeline.

A closed tet mesh goes in, a FEM modal model comes out (`mesh2modes`), and 48 kHz modal
audio is rendered from impacts (`api.make_synth` -> `ModalSynth.render_seconds`). The
module layout mirrors `mesheditor_tpu`, so each part's JAX counterpart sits at the same
path there; the JAX package is the reference this port is tested against.

Precision follows the reference: the solve runs in float64 (Hopper has native f64 and
cuSOLVER, so none of the reference's emulated-f64 workarounds are carried over) and the
render in float32 with exact multiply-adds, never a matmul. TF32 stays off so that any
float32 product is a full float32 product.

Entry points take an explicit `device` (default "cuda"); a CUDA device without a card
raises instead of quietly running on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .types import (  # noqa: E402
    AcousticMaterial,
    AcousticMaterialProperties,
    MassProperties,
    ModalModes,
    ModalSolveSettings,
    ModalSoundControls,
    SolverConfig,
    SolveProfile,
    TetMesh,
)
from .materials import ACOUSTIC_MATERIALS, find_material  # noqa: E402
from .solve.mesh2modes import ModalResult, SolveReuse, mesh2modes  # noqa: E402
from .solve.postprocess import postprocess_modes, rescale_modes  # noqa: E402

__all__ = [
    "AcousticMaterial",
    "AcousticMaterialProperties",
    "MassProperties",
    "ModalModes",
    "ModalSolveSettings",
    "ModalSoundControls",
    "SolverConfig",
    "SolveProfile",
    "TetMesh",
    "ACOUSTIC_MATERIALS",
    "find_material",
    "mesh2modes",
    "ModalResult",
    "SolveReuse",
    "postprocess_modes",
    "rescale_modes",
]
