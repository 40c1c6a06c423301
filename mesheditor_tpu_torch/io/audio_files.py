"""WAV read/write (16/24/32-bit PCM and float32), stdlib-only."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path, samples: np.ndarray, sample_rate: int = 48_000) -> None:
    """Write mono or (channels, n) float samples in [-1, 1] as 16-bit PCM."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, n = samples.shape
    clipped = np.clip(samples, -1.0, 1.0)
    pcm = (clipped * 32767.0).astype("<i2").T.reshape(-1)
    target = path if hasattr(path, "write") else str(path)
    with wave.open(target, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())


def read_wav(path) -> tuple[np.ndarray, int]:
    """Returns (samples (channels, n) float32 in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, channels).T, rate
