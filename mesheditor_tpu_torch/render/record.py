"""Headless recording: frame sequences -> PNG sequence / GIF / mp4 (counterpart of
mesheditor_tpu/render/record.py; reference: src/VideoRecorder.h:12-29 — ffmpeg-subprocess
H.264 at a fixed fps — and the deterministic fixed-step headless capture of
--record/--render, README.md:163-197).

PNG is written and read with the standard library (zlib + struct), so frames, goldens and
glTF PNG textures need nothing beyond Python; mp4 uses an ffmpeg subprocess exactly like
the reference when one is on PATH and falls back to an animated GIF, which needs PIL.
Frames are rendered fixed-step, so recordings are deterministic corpus artifacts.
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


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W, 4) uint8 -> PNG file bytes: 8-bit RGB or RGBA, no interlace,
    filter 0 (none) on every row, one zlib stream."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim != 3 or pixels.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes an (H, W, 3) or (H, W, 4) image, not "
                         f"{pixels.shape}")
    h, w, ch = pixels.shape
    rows = np.zeros((h, 1 + ch * w), np.uint8)  # a 0 filter byte leads every row
    rows[:, 1:] = pixels.reshape(h, ch * w)
    color = 2 if ch == 3 else 6
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
# Adam7 passes: (first row, first column, row step, column step).
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of `rows` scanlines of `stride` bytes (each led by
    its filter byte); `bpp` is the byte distance of the Sub/Average/Paeth neighbour."""
    lines = raw[:rows * (1 + stride)].reshape(rows, 1 + stride)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(rows):
        kind, line = int(lines[y, 0]), lines[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:  # Up
            cur = (line + prev) & 255
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            vals, up, cur_l = line.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    p = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[i] = (vals[i] + p) & 255
            cur = np.asarray(cur_l, np.int64)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def _samples(lines: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines -> (rows, width, channels) integer samples at `depth` bits."""
    rows = lines.shape[0]
    if depth == 16:
        vals = lines.view(">u2").astype(np.int64)
    elif depth == 8:
        vals = lines.astype(np.int64)
    else:  # 1, 2 or 4 bits, big-endian within each byte
        bits = np.unpackbits(lines, axis=1).reshape(rows, -1, depth)
        vals = (bits.astype(np.int64) << np.arange(depth - 1, -1, -1)).sum(-1)
    return vals[:, :width * channels].reshape(rows, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> (H, W, 4) uint8 RGBA, with zlib and no PIL: every colour type
    (grey, RGB, palette, grey-alpha, RGBA), every bit depth (16-bit samples keep their high
    byte, 1/2/4-bit grey scales to 0-255), tRNS transparency, every filter type and Adam7
    interlacing. At 8 bits and below, the RGBA it gives is PIL's `convert("RGBA")` of the same
file."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, head, palette, trns = 8, [], None, None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if head is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = head
    if color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"PNG colour type {color} at bit depth {depth} is not valid")
    channels = _PNG_CHANNELS[color]
    bits = channels * depth
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = np.zeros((h, w, channels), np.int64)
    at = 0
    for y0, x0, dy, dx in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * bits + 7) // 8
        lines = _unfilter(raw[at:], ph, stride, max(bits // 8, 1))
        at += ph * (1 + stride)
        img[y0::dy, x0::dx] = _samples(lines, pw, channels, depth)
    alpha = np.full((h, w), 255, np.int64)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        idx = img[..., 0]
        if trns is not None:
            table = np.full(256, 255, np.int64)
            table[:len(trns)] = np.frombuffer(trns, np.uint8)
            alpha = table[idx]
        rgba = np.concatenate([palette[idx].astype(np.int64), alpha[..., None]], axis=-1)
        return rgba.astype(np.uint8)
    if trns is not None and color in (0, 2):  # one fully transparent colour
        key = np.frombuffer(trns, ">u2").astype(np.int64)[:channels]
        alpha = np.where((img == key).all(-1), 0, 255)
    if depth == 16:
        img = img >> 8
    elif depth < 8:
        img = img * 255 // ((1 << depth) - 1)
    if color in (4, 6):
        alpha, img = img[..., -1], img[..., :-1]
    rgb = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img
    return np.concatenate([rgb, alpha[..., None]], axis=-1).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a PNG file (alpha dropped: the render goldens and the
    recorded frames are opaque), decoded by `decode_png`."""
    return decode_png(Path(path).read_bytes())[..., :3]


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
    from .scene_render import RenderSettings, render_mesh

    settings = settings or RenderSettings(width=320, height=240)
    positions = np.asarray(positions, np.float32)
    for cam in turntable_cameras(positions, n_frames, elevation_deg):
        yield render_mesh(positions, triangles, camera=cam, settings=settings,
                          vertex_values=vertex_values, device=device)


def turntable_cameras(points, n_frames: int, elevation_deg: float = 25.0):
    """The turntable's cameras: `n_frames` fixed azimuth steps from -60 degrees, each
    framing `points`."""
    from .camera import frame_points

    for i in range(n_frames):
        yield frame_points(points, azimuth_deg=-60.0 + 360.0 * i / n_frames,
                           elevation_deg=elevation_deg)


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
