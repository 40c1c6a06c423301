"""File I/O (counterpart of mesheditor_tpu/io): WAV files and the content-addressed modal
model store. The RealImpact and glTF readers are not ported yet."""

from .audio_files import read_wav, write_wav
from .model_store import load_modal_model, save_modal_model, modal_model_key

__all__ = [
    "read_wav",
    "write_wav",
    "load_modal_model",
    "save_modal_model",
    "modal_model_key",
]
