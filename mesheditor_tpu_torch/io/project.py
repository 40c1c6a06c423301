"""Project archives: one compressed file bundling scene state + assets.

The reference's .project is a zstd archive of the persistent state + session assets
(src/Compress.h:5-6, snapshot/SaveState.h:10-15). Here: a zip (deflate, stdlib) holding
the byte-exact scene snapshot, the action log, and any referenced modal model artifacts —
load restores a registry whose snapshot byte-compares to the saved one.
"""

from __future__ import annotations

import io
import zipfile
from pathlib import Path

from ..scene.registry import Registry
from ..scene.snapshot import restore_scene, snapshot_scene
from ..scene.components import ModalModel


def save_project(path, registry: Registry, modal_dir=None, action_log_path=None) -> None:
    path = Path(path)
    snap = snapshot_scene(registry)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("scene.snapshot", snap)
        if action_log_path and Path(action_log_path).exists():
            z.write(action_log_path, "session.actions")
        if modal_dir:
            modal_dir = Path(modal_dir)
            for e, mm in registry.view(ModalModel):
                p = modal_dir / mm.path if mm.path else None
                if p and p.exists():
                    z.write(p, f"modal/{p.name}")


def load_project(path, extract_modal_to=None) -> Registry:
    path = Path(path)
    with zipfile.ZipFile(path) as z:
        registry = restore_scene(z.read("scene.snapshot"))
        if extract_modal_to:
            out = Path(extract_modal_to)
            out.mkdir(parents=True, exist_ok=True)
            for name in z.namelist():
                if name.startswith("modal/"):
                    (out / Path(name).name).write_bytes(z.read(name))
    return registry
