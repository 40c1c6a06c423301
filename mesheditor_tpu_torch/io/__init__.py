"""Audio file I/O (counterpart of mesheditor_tpu/io; only the WAV files are ported yet)."""

from .audio_files import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
