"""Audio output streaming: the headless analog of the reference's audio device layer
(counterpart of mesheditor_tpu/synth/stream.py).

The reference opens a miniaudio device whose data callback runs ProcessAudio
(src/audio/AudioDevice.cpp:24-50 -> AudioSystem.cpp:1469-1491): mix modal synthesis with
impact-sample playback, apply output gain/mute, optionally record. This framework targets
servers without audio hardware, so the device is a *sink*: a block clock pulls blocks
from the mix pipeline on a worker thread and hands them to any callback (file writer,
socket, queue). Semantics kept from the reference:

- the mix = modal render * modal_level + sample playback * sample_gain, master volume/mute
- sample playback: one-shot vertex-tap recordings (the RealImpact Samples mode,
  SoundVerticesModel::Samples) mixed until exhausted
- recording: capture the mix into a buffer, save as wav
- the render never blocks on IO (blocks queue to the sink thread)
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..types import ModalSoundControls
from .engine import ModalSynth


@dataclass
class SamplePlayback:
    """A one-shot recording being played back (vertex-tap samples mode)."""

    samples: np.ndarray
    position: int = 0
    gain: float = 1.0


class AudioStream:
    """Pulls blocks from a ModalSynth, mixes playback, and feeds a sink."""

    def __init__(
        self,
        synth: ModalSynth,
        sink: Optional[Callable[[np.ndarray], None]] = None,
        controls: ModalSoundControls = ModalSoundControls(),
        block_size: int = 512,
        volume: float = 1.0,
    ):
        self.synth = synth
        self.sink = sink
        self.controls = controls
        self.block_size = block_size
        self.volume = volume
        self.muted = False
        self._playbacks: list[SamplePlayback] = []
        self._recording: Optional[list[np.ndarray]] = None
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._sink_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sample playback (the Samples sound-vertices model) --

    def play_sample(self, samples: np.ndarray, gain: float = 1.0) -> None:
        self._playbacks.append(
            SamplePlayback(np.asarray(samples, dtype=np.float32).reshape(-1), gain=gain)
        )

    # -- recording --

    def start_recording(self) -> None:
        self._recording = []

    def stop_recording(self) -> np.ndarray:
        rec = self._recording or []
        self._recording = None
        return np.concatenate(rec) if rec else np.zeros(0, np.float32)

    # -- the block pipeline (ProcessAudio analog) --

    def process_block(self) -> np.ndarray:
        """One block of output mix (modal + playback, leveled). The render's device tensor
        comes to the host once per block, here."""
        out = self.synth.render(self.block_size).cpu().numpy() * np.float32(
            self.controls.modal_level
        )
        done = []
        for p in self._playbacks:
            n = min(self.block_size, p.samples.size - p.position)
            if n > 0:
                out[:n] += p.samples[p.position : p.position + n] * np.float32(
                    p.gain * self.controls.sample_gain
                )
                p.position += n
            if p.position >= p.samples.size:
                done.append(p)
        for p in done:
            self._playbacks.remove(p)
        out = out * np.float32(0.0 if self.muted else self.volume)
        if self._recording is not None:
            self._recording.append(out.copy())
        return out

    # -- sink thread (write-behind, render never blocks on IO) --

    def _sink_loop(self):
        while not self._stop.is_set() or not self._q.empty():
            try:
                block = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if self.sink is not None:
                self.sink(block)

    def start(self) -> None:
        self._stop.clear()
        self._sink_thread = threading.Thread(target=self._sink_loop, daemon=True)
        self._sink_thread.start()

    def pump(self, blocks: int) -> None:
        """Render `blocks` blocks, queuing each to the sink."""
        for _ in range(blocks):
            self._q.put(self.process_block())

    def stop(self) -> None:
        self._stop.set()
        if self._sink_thread is not None:
            self._sink_thread.join()
            self._sink_thread = None

    def render_to_wav(self, path, seconds: float, sample_rate: Optional[int] = None) -> None:
        from ..io.audio_files import write_wav

        self.start_recording()
        blocks = int(np.ceil(seconds * self.synth.sample_rate / self.block_size))
        for _ in range(blocks):
            self.process_block()
        write_wav(path, self.stop_recording(), int(sample_rate or self.synth.sample_rate))
