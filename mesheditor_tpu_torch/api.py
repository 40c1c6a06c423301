"""Top-level convenience API (counterpart of mesheditor_tpu/api.py; `make_synth` only —
surface meshing and the Hertz strike come with the solve-input slice)."""

from __future__ import annotations

from typing import Optional, Sequence

from .solve.mesh2modes import ModalResult
from .synth.engine import ModalSynth
from .types import ModalModes


def make_synth(
    results: Sequence[ModalResult | ModalModes],
    gains: Optional[Sequence[float]] = None,
    sample_rate: float = 48_000.0,
    modal_level: float = 0.5,
    device="cuda",
    **kwargs,
) -> ModalSynth:
    """A synth over solved models on `device`. Per-object output gain defaults to the
    reference's mass-normalized scale: modal_level / mode_count (AudioSystem.cpp:576-579)."""
    modes_list = [r.modes if isinstance(r, ModalResult) else r for r in results]
    if gains is None:
        gains = [
            modal_level / max(m.num_modes, 1) * 1e3  # 1e3: mass-normalized shapes are tiny
            for m in modes_list
        ]
    return ModalSynth(modes_list, gains, sample_rate, device=device, **kwargs)
