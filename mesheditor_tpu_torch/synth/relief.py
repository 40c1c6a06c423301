"""Surface relief: a mesoscale height track sampled from a tangent-space normal map along
a texture path.

Mirrors the reference's UpdateSurfaceRelief (src/audio/SurfaceRelief.cpp:15-35): integrate
the normal map's tangent slopes along a path with leak-to-zero (so the track stays bounded
and zero-mean-ish), bilinear wrap sampling. The result is a RoughnessTrack a sustained
voice rides in addition to the microscale finish; content-keyed for pool sharing.
"""

from __future__ import annotations

import numpy as np

from .tracks import RoughnessTrack, TRACK_SAMPLES, hash_params, make_profile_track


def _bilinear_wrap(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Sample img (H, W[, C]) at wrapped continuous (u, v) in texture units [0,1)."""
    h, w = img.shape[:2]
    x = (u % 1.0) * w
    y = (v % 1.0) * h
    x0 = np.floor(x).astype(int) % w
    y0 = np.floor(y).astype(int) % h
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h
    fx = (x - np.floor(x))[..., None] if img.ndim == 3 else (x - np.floor(x))
    fy = (y - np.floor(y))[..., None] if img.ndim == 3 else (y - np.floor(y))
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def relief_track_from_normal_map(
    normal_map: np.ndarray,
    path_uv: np.ndarray,
    texel_size_m: float,
    amplitude_m: float = 1e-4,
    count: int = TRACK_SAMPLES,
    leak: float = 1e-3,
) -> RoughnessTrack:
    """Integrate tangent-space slopes (nx/nz, stored as a (H, W, 3) map in [-1, 1]) along
    `path_uv` ((k, 2) closed texture path), leaking toward zero so the height stays
    bounded. Returns a normalized track whose `rms` carries the physical amplitude."""
    nm = np.asarray(normal_map, dtype=np.float64)
    if nm.ndim != 3 or nm.shape[2] < 3:
        raise ValueError("normal map must be (H, W, >=3)")
    path = np.asarray(path_uv, dtype=np.float64).reshape(-1, 2)
    # Resample the path to `count` points (closed).
    t = np.linspace(0, 1, count, endpoint=False)
    seg = np.linspace(0, 1, path.shape[0], endpoint=False)
    u = np.interp(t, seg, path[:, 0], period=1.0)
    v = np.interp(t, seg, path[:, 1], period=1.0)
    n = _bilinear_wrap(nm, u, v)
    nz = np.maximum(np.abs(n[:, 2]), 1e-3) * np.sign(n[:, 2] + (n[:, 2] == 0))
    # Slope along the path: the tangent-plane gradient projected on the travel direction.
    du = np.diff(np.concatenate([u, u[:1]]))
    dv = np.diff(np.concatenate([v, v[:1]]))
    step = np.sqrt(du**2 + dv**2)
    dirs = np.stack([np.where(step > 0, du / np.where(step == 0, 1, step), 0.0),
                     np.where(step > 0, dv / np.where(step == 0, 1, step), 0.0)], axis=1)
    slope = -(n[:, 0] * dirs[:, 0] + n[:, 1] * dirs[:, 1]) / nz
    heights = np.empty(count)
    acc = 0.0
    for i in range(count):  # leaky integration (sequential, done once per content key)
        acc = acc * (1.0 - leak) + slope[i] * step[i]
        heights[i] = acc
    track = make_profile_track(heights * texel_size_m, texel_size_m)
    # Scale the physical RMS to the requested mesoscale amplitude when the map is flat.
    if track.rms == 0:
        track.rms = amplitude_m
    return track


def relief_content_key(map_id: int, texel_size_m: float, amplitude_m: float) -> int:
    return hash_params(0xEE11F, float(map_id), texel_size_m, amplitude_m)
