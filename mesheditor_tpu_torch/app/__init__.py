"""The interactive browser viewer/editor (counterpart of mesheditor_tpu/app)."""

from .viewer import ViewerApp, serve

__all__ = ["ViewerApp", "serve"]
