"""File I/O (counterpart of mesheditor_tpu/io): WAV files, the content-addressed modal
model store and the RealImpact dataset. glTF (`io.gltf`) and projects (`io.project`) are
imported by name, as in the reference."""

from .audio_files import read_wav, write_wav
from .model_store import load_modal_model, save_modal_model, modal_model_key
from .realimpact import RealImpactScan, load_listener_points, load_realimpact_scan

__all__ = [
    "read_wav",
    "write_wav",
    "load_modal_model",
    "save_modal_model",
    "modal_model_key",
    "RealImpactScan",
    "load_listener_points",
    "load_realimpact_scan",
]
