"""Headless recording: frame sequences -> PNG sequence / GIF / mp4 (counterpart of
mesheditor_tpu/render/record.py; reference: src/VideoRecorder.h:12-29 — ffmpeg-subprocess
H.264 at a fixed fps — and the deterministic fixed-step headless capture of
--record/--render, README.md:163-197).

PNG frames are written with the standard library (zlib + struct), so they need nothing
beyond Python; mp4 uses an ffmpeg subprocess exactly like the reference when one is on
PATH and falls back to an animated GIF, which needs PIL. Frames are rendered fixed-step,
so recordings are deterministic corpus artifacts.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """Float [0, 1] image -> uint8, rounded half up."""
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG file bytes: 8-bit RGB, no interlace, filter 0 (none) on
    every row, one zlib stream."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes an (H, W, 3) image, not {rgb.shape}")
    h, w = rgb.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # a 0 filter byte leads every row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_frames(path_base, frames) -> list:
    """Numbered PNG frames `<base>_0000.png ...` (the render-corpus form)."""
    base = Path(path_base)
    out = []
    for i, f in enumerate(frames):
        p = base.with_name(f"{base.stem}_{i:04d}.png")
        p.write_bytes(encode_png(to_u8(f)))
        out.append(p)
    return out


def write_gif(path, frames, fps: float = 30.0) -> None:
    """Animated GIF via PIL (no external encoder needed)."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError("write_gif needs PIL (the Pillow package); write .png frames "
                          "instead, or .mp4 where ffmpeg is installed") from err

    ims = [Image.fromarray(to_u8(f)) for f in frames]
    ims[0].save(
        str(path), save_all=True, append_images=ims[1:],
        duration=max(int(round(1000.0 / fps)), 1), loop=0,
    )


def write_mp4(path, frames, fps: float = 60.0) -> bool:
    """H.264 via an ffmpeg subprocess (the reference's encoder path,
    VideoRecorder.h:12-29). Returns False when ffmpeg is not available."""
    if shutil.which("ffmpeg") is None:
        return False
    frames = [np.ascontiguousarray(to_u8(f)) for f in frames]
    h, w = frames[0].shape[:2]
    proc = subprocess.Popen(
        ["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo", "-pix_fmt", "rgb24",
         "-s", f"{w}x{h}", "-r", str(fps), "-i", "-", "-c:v", "libx264",
         "-pix_fmt", "yuv420p", str(path)],
        stdin=subprocess.PIPE,
    )
    for f in frames:
        proc.stdin.write(f.tobytes())
    proc.stdin.close()
    return proc.wait() == 0


def record(path, frames, fps: float = 30.0) -> Path:
    """Write a recording, picking the encoder from the suffix (.mp4 needs ffmpeg and
    falls back to .gif beside it; .gif needs PIL; any other suffix writes numbered PNG
    frames)."""
    path = Path(path)
    frames = list(frames)
    if not frames:
        raise ValueError("no frames to record")
    if path.suffix == ".mp4":
        if write_mp4(path, frames, fps):
            return path
        path = path.with_suffix(".gif")
    if path.suffix == ".gif":
        write_gif(path, frames, fps)
        return path
    write_frames(path, frames)
    return path


def turntable_frames(positions, triangles, n_frames: int = 36, settings=None,
                     elevation_deg: float = 25.0, vertex_values=None, device="cuda"):
    """Fixed-step orbit around a mesh (the reference's --play capture analog):
    yields one rendered frame per azimuth step, deterministically, rendered on
    `device`."""
    from .camera import frame_points
    from .scene_render import RenderSettings, render_mesh

    settings = settings or RenderSettings(width=320, height=240)
    positions = np.asarray(positions, np.float32)
    for i in range(n_frames):
        az = -60.0 + 360.0 * i / n_frames
        cam = frame_points(positions, azimuth_deg=az, elevation_deg=elevation_deg)
        yield render_mesh(positions, triangles, camera=cam, settings=settings,
                          vertex_values=vertex_values, device=device)


def animation_frames(registry, clip, camera=None, seconds: float | None = None,
                     fps: float = 30.0, settings=None, motion_blur_steps: int = 1,
                     shutter: float = 0.5, device="cuda"):
    """Fixed-step clip playback: samples the animation clip (scene/animation.py) at
    the exact frame clock and renders each step on `device` — the deterministic headless
    capture discipline (README.md:182, fixed-step GPU-paced).

    motion_blur_steps > 1 renders that many substeps across the frame's shutter
    interval and averages them — the reference's multi-step BlurAccumulate resolve
    (src/viewport/ViewportRenderGpu.h:23-35), re-expressed as plain accumulation
    (deterministic; substep times are exact fractions of the frame clock)."""
    from ..scene.animation import evaluate_clip
    from ..scene.components import MeshSurface
    from .scene_render import RenderSettings, render_scene

    settings = settings or RenderSettings(width=320, height=240)
    if seconds is None:
        seconds = clip.duration
    n = max(int(round(seconds * fps)), 1)
    steps = max(int(motion_blur_steps), 1)

    def render_at(t):
        weights = evaluate_clip(registry, clip, t)
        for e, w in weights.items():
            surf = registry.get(e, MeshSurface)
            if surf is not None:
                surf.morph_weights = np.asarray(w, np.float64)
        return render_scene(registry, camera=camera, settings=settings,
                            device=device).image()

    for i in range(n):
        if steps == 1:
            yield render_at(i / fps)
            continue
        acc = None
        for k in range(steps):
            t = (i + shutter * k / (steps - 1 if steps > 1 else 1)) / fps
            img = render_at(t)
            acc = img if acc is None else acc + img
        yield acc / steps
