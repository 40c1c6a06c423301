"""Content-hash-addressed, write-once modal model files.

The reference persists solved modal models as zpp_bits blobs named by a content hash under
the project's modal/ directory, so replaying `ApplyModalModel{path}` is deterministic
(src/audio/ModalModelFile.cpp:26-48). Here the artifact is an .npz with the same write-once
content-addressed discipline: saving identical data yields the identical path and never
rewrites an existing file.
"""

from __future__ import annotations

import hashlib
import io
from pathlib import Path

import numpy as np

from ..types import MassProperties, ModalModes


def _pack(modes: ModalModes, mass: MassProperties, extra: dict | None = None) -> bytes:
    buf = io.BytesIO()
    arrays = {
        "freqs": modes.freqs,
        "t60s": modes.t60s,
        "shapes": modes.shapes,
        "vertices": modes.vertices,
        "positions": modes.positions,
        "indices": modes.indices,
        "original_fundamental_freq": np.float32(modes.original_fundamental_freq),
        "baked_scale": modes.baked_scale,
        "mass": np.float64(mass.mass),
        "center_of_mass": mass.center_of_mass,
        "inertia_diagonal": mass.inertia_diagonal,
        "inertia_orientation": mass.inertia_orientation,
    }
    if extra:
        arrays.update(extra)
    # Deterministic bytes: fixed key order, uncompressed.
    np.savez(buf, **{k: arrays[k] for k in sorted(arrays)})
    return buf.getvalue()


def modal_model_key(modes: ModalModes, mass: MassProperties) -> str:
    """The content hash a save of this model would use (stable across sessions)."""
    h = hashlib.sha256()
    for arr in (modes.freqs, modes.t60s, modes.shapes, modes.positions, modes.baked_scale):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(np.float64(mass.mass).tobytes())
    return h.hexdigest()[:32]


def save_modal_model(
    directory, modes: ModalModes, mass: MassProperties, extra: dict | None = None
) -> Path:
    """Write-once save; returns the content-addressed path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{modal_model_key(modes, mass)}.npz"
    if not path.exists():
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(_pack(modes, mass, extra))
        tmp.rename(path)
    return path


def load_modal_model(path) -> tuple[ModalModes, MassProperties]:
    with np.load(path) as z:
        modes = ModalModes(
            freqs=z["freqs"],
            t60s=z["t60s"],
            shapes=z["shapes"],
            vertices=z["vertices"],
            positions=z["positions"],
            indices=z["indices"],
            original_fundamental_freq=float(z["original_fundamental_freq"]),
            baked_scale=z["baked_scale"],
        )
        mass = MassProperties(
            mass=float(z["mass"]),
            center_of_mass=z["center_of_mass"],
            inertia_diagonal=z["inertia_diagonal"],
            inertia_orientation=z["inertia_orientation"],
        )
    return modes, mass
