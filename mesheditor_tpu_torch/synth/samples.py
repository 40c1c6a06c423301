"""Recorded-sample playback voices (reference: SoundVerticesModel::Samples —
vertex-tap playback of RealImpact recordings for ground-truth comparison against the
modal render, src/audio/AudioTypes.h:39-46, playback mix at AudioSystem.cpp:1475-1489).

A small host-side mixer: objects register per-vertex recorded clips (e.g. one
RealImpact deconvolved recording per impact vertex); striking a vertex in Samples mode
starts a playback voice; `mix(n)` renders the next block, summed with polyphony. Pure
numpy — playback is IO-bound, not a device kernel."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_SAMPLE_VOICES = 32


@dataclass
class _Voice:
    clip: np.ndarray
    position: int = 0
    gain: float = 1.0


@dataclass
class SamplePlayer:
    """Per-scene sample playback (the Samples half of the Samples/Modal A-B)."""

    sample_rate: float = 48_000.0
    # (obj, vertex) -> clip; set via set_vertex_samples (SetVertexSamples analog).
    _clips: dict = field(default_factory=dict)
    _voices: list = field(default_factory=list)
    voices_refused: int = 0

    def set_vertex_samples(self, obj: int, clips) -> None:
        """Register clips for an object's excite vertices: `clips` is a sequence of
        1-D float arrays, one per vertex (index-aligned with SoundVertices)."""
        for v, clip in enumerate(clips):
            c = np.asarray(clip, np.float32).reshape(-1)
            if c.size:
                self._clips[(obj, v)] = c

    def clear_object(self, obj: int) -> None:
        self._clips = {k: v for k, v in self._clips.items() if k[0] != obj}

    def has_samples(self, obj: int) -> bool:
        return any(k[0] == obj for k in self._clips)

    def trigger(self, obj: int, vertex: int, gain: float = 1.0) -> bool:
        """Start playback of the recording at (obj, vertex); False if none exists or
        the voice pool is full (counted, like the synth's refusal counters)."""
        clip = self._clips.get((obj, vertex))
        if clip is None:
            return False
        if len(self._voices) >= MAX_SAMPLE_VOICES:
            self.voices_refused += 1
            return False
        self._voices.append(_Voice(clip=clip, gain=float(gain)))
        return True

    @property
    def active_voices(self) -> int:
        return len(self._voices)

    def mix(self, num_samples: int) -> np.ndarray:
        """Render the next block: sum of all live playback voices; finished voices
        retire. Exactly block-boundary invariant (pure indexing)."""
        out = np.zeros(num_samples, np.float32)
        alive = []
        for v in self._voices:
            n = min(num_samples, v.clip.size - v.position)
            if n > 0:
                out[:n] += v.gain * v.clip[v.position:v.position + n]
                v.position += n
            if v.position < v.clip.size:
                alive.append(v)
        self._voices = alive
        return out
