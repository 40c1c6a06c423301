"""Prefiltered image-based environment lighting in PyTorch (counterpart of
mesheditor_tpu/render/environment.py).

The reference prefilters an environment cubemap with GGX compute kernels at load time
and samples it by reflection vector + roughness in the PBR shader
(src/render/IblPrefilterPipelines.h, Textures.cpp). Here the same split-sum
approximation runs over an EQUIRECTANGULAR map on the device, producing a
(levels, H, W, 3) roughness mip stack:

  level 0            = the (resized) radiance map, mirror reflections
  level k            = GGX-convolved radiance at roughness k/(levels-1), fixed
                       Fibonacci-lattice importance samples (deterministic)
  diffuse irradiance = cosine-hemisphere convolution, stored as one extra row stack

The shader samples the stack bilinearly by reflection direction with a fractional
level lerp (trilinear-across-roughness), and the diffuse term by the normal — the
standard split-sum IBL. The JAX package's scans over the lattice samples are loops over
the same fixed lattices, in the same order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device


class PrefilteredEnv(NamedTuple):
    specular: torch.Tensor  # (L, H, W, 3) f32 linear radiance by roughness level
    diffuse: torch.Tensor   # (H, W, 3) f32 cosine-convolved irradiance / pi
    levels: int


def sample_equirect(env, d):
    """Bilinear sample of an (H, W, 3) equirect map at unit directions d (..., 3)."""
    h, w = env.shape[-3], env.shape[-2]
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 0], d[..., 2])
    fy = torch.clamp(theta / math.pi * h - 0.5, 0.0, h - 1.0)
    fx = (phi + math.pi) / (2 * math.pi) * w - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]

    def tex(ix, iy):
        ix = torch.remainder(ix.to(torch.int64), w)  # azimuth wraps
        iy = torch.clamp(iy.to(torch.int64), 0, h - 1)
        return env[iy, ix]

    return ((1 - ax) * (1 - ay) * tex(x0, y0) + ax * (1 - ay) * tex(x0 + 1, y0)
            + (1 - ax) * ay * tex(x0, y0 + 1) + ax * ay * tex(x0 + 1, y0 + 1))


def _fibonacci_hemisphere(n):
    """Deterministic hemisphere lattice (z-up local frame), host-side constants."""
    i = np.arange(n) + 0.5
    phi = 2 * np.pi * i * (1 / 1.618033988749895 % 1.0)
    return i / n, phi  # (u ~ stratified radial), azimuth


def _ggx_dirs(roughness, n_samples):
    """GGX half-vector importance samples around +z for one roughness (host consts)."""
    u, phi = _fibonacci_hemisphere(n_samples)
    a = max(roughness * roughness, 1e-3)
    ct = np.sqrt((1.0 - u) / (1.0 + (a * a - 1.0) * u))
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    return np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)  # (S, 3)


def _prefilter(env, dirs, h_samples_all, levels, samples):
    """GGX-convolve the radiance map per roughness level (split-sum prefilter).
    env (H, W, 3), dirs (H, W, 3), h_samples_all (levels - 1, S, 3): float32 tensors on one
    device; the lattices are read on the host, so the loops never wait on the device."""
    # Local frame per texel: z = dir, x/y any orthonormal pair.
    z = dirs
    up = torch.where(torch.abs(z[..., 1:2]) < 0.99,
                     torch.tensor([0.0, 1.0, 0.0], device=z.device),
                     torch.tensor([1.0, 0.0, 0.0], device=z.device))
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)), min=1e-9)
    y = torch.linalg.cross(z, x, dim=-1)

    def rotate(s):
        return float(s[0]) * x + float(s[1]) * y + float(s[2]) * z

    levels_out = [env]
    for k in range(1, levels):
        # Half-vectors in the local frame; N = V = z (the standard prefilter
        # approximation), L = reflect(V, H) = 2(V.H)H - V.
        total = torch.zeros_like(env)
        wsum = torch.zeros(env.shape[:2] + (1,), dtype=env.dtype, device=env.device)
        for hs in h_samples_all[k - 1]:
            hw = rotate(hs)  # (H, W, 3)
            vdh = (z * hw).sum(-1, keepdim=True)
            l = 2.0 * vdh * hw - z
            ndl = (z * l).sum(-1, keepdim=True)
            wgt = torch.clamp(ndl, min=0.0)
            total = total + sample_equirect(env, l) * wgt
            wsum = wsum + wgt
        levels_out.append(total / torch.clamp(wsum, min=1e-9))
    spec = torch.stack(levels_out)

    # Diffuse irradiance: cosine-weighted hemisphere convolution with the same lattice.
    u, phi = _fibonacci_hemisphere(samples)
    ct = np.sqrt(1.0 - u)  # cosine-weighted
    st = np.sqrt(u)
    dl = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1).astype(np.float32)
    total = torch.zeros_like(env)
    for ds in dl:
        total = total + sample_equirect(env, rotate(ds))
    return spec, total / samples


def prefilter_environment(env_equirect, levels: int = 5, base_height: int = 64,
                          samples: int = 96, device="cuda") -> PrefilteredEnv:
    """Build the roughness mip stack on `device` from an equirect radiance map (uint8 sRGB
    or float linear, host array). Deterministic (fixed Fibonacci lattice)."""
    dev = resolve_device(device)
    env = np.asarray(env_equirect)
    if env.dtype == np.uint8:
        from .shading import srgb_to_linear

        env = srgb_to_linear(env[..., :3].astype(np.float32) / 255.0)
    env = np.asarray(env[..., :3], np.float32)
    h = base_height
    w = 2 * h
    # Box-resample to the prefilter resolution (cheap, deterministic).
    ys = (np.linspace(0, env.shape[0] - 1e-3, h)).astype(np.int64)
    xs = (np.linspace(0, env.shape[1] - 1e-3, w)).astype(np.int64)
    env_small = torch.as_tensor(np.ascontiguousarray(env[ys][:, xs]), device=dev)
    dirs = torch.as_tensor(_dirs_equirect_np(h, w).astype(np.float32), device=dev)
    rough = [k / (levels - 1) for k in range(1, levels)]
    h_all = np.stack([_ggx_dirs(r, samples) for r in rough]).astype(np.float32)
    spec, diff = _prefilter(env_small, dirs, h_all, levels, samples)
    return PrefilteredEnv(spec, diff, levels)


def shade_ibl(env: PrefilteredEnv, n, view, albedo, metallic, roughness):
    """Split-sum IBL term: prefiltered specular by reflection + roughness level,
    cosine irradiance diffuse; Schlick fresnel with roughness-aware grazing term."""
    r = torch.clamp(roughness, 0.0, 1.0)
    refl = 2.0 * (n * view).sum(-1, keepdim=True) * n - view
    lvl = r * (env.levels - 1)
    lo = torch.clamp(torch.floor(lvl).to(torch.int64), 0, env.levels - 1)
    hi = torch.clamp(lo + 1, 0, env.levels - 1)
    frac = (lvl - lo.to(lvl.dtype))[..., None]
    # Sample every level once (L is tiny), then gather the per-pixel pair — the
    # trilinear-across-roughness lookup without dynamic level indexing.
    spec_all = torch.stack([sample_equirect(e, refl) for e in env.specular])  # (L,H,W,3)
    spec_lo = torch.gather(spec_all, 0, lo[None, ..., None].expand(1, *refl.shape))[0]
    spec_hi = torch.gather(spec_all, 0, hi[None, ..., None].expand(1, *refl.shape))[0]
    spec_env = spec_lo * (1 - frac) + spec_hi * frac
    irr = sample_equirect(env.diffuse, n)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    ndv = torch.clamp((n * view).sum(-1, keepdim=True), min=1e-4)
    g = 1.0 - ndv
    g2 = g * g
    fr = f0 + (torch.maximum(1.0 - r[..., None], f0) - f0) * (g * (g2 * g2))
    kd = (1.0 - fr) * (1.0 - metallic[..., None])
    return kd * albedo * irr + fr * spec_env


# ---- cubemap <-> equirect converters + SH9 irradiance (EXT_lights_image_based) ----
#
# The wire format of EXT_lights_image_based is a cubemap mip pyramid + l=2 spherical-
# harmonic irradiance (the reference imports it as the scene IBL, README.md:93-119);
# this renderer's native environment is an equirect radiance map, so import/export
# resample between the two. Host-side numpy: conversion happens once at IO time.

_CUBE_FACE_AXES = (
    # (forward, u_axis, v_axis) per GL cubemap face order +X -X +Y -Y +Z -Z;
    # u, v span [-1, 1] left->right, top->bottom.
    ((1, 0, 0), (0, 0, -1), (0, -1, 0)),
    ((-1, 0, 0), (0, 0, 1), (0, -1, 0)),
    ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
    ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
    ((0, 0, 1), (1, 0, 0), (0, -1, 0)),
    ((0, 0, -1), (-1, 0, 0), (0, -1, 0)),
)


def _dirs_equirect_np(h, w):
    """Unit direction of every texel center of an equirect map (y up, +z forward)."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = u * 2 * np.pi - np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sp, cp = np.sin(phi)[None, :], np.cos(phi)[None, :]
    return np.stack([st * sp, ct * np.ones_like(sp * st), st * cp], -1)


def _sample_equirect_np(env, d):
    """Nearest-texel equirect sample at unit directions d (..., 3), numpy."""
    h, w = env.shape[0], env.shape[1]
    theta = np.arccos(np.clip(d[..., 1], -1.0, 1.0))
    phi = np.arctan2(d[..., 0], d[..., 2])
    iy = np.clip((theta / np.pi * h).astype(np.int64), 0, h - 1)
    ix = np.mod(((phi + np.pi) / (2 * np.pi) * w).astype(np.int64), w)
    return env[iy, ix]


def cube_faces_from_equirect(env, size: int, rotation=None) -> np.ndarray:
    """(6, size, size, 3) float cubemap faces resampled from an equirect map.
    `rotation` (wxyz quaternion) rotates the environment before sampling."""
    env = np.asarray(env, np.float32)
    s = (np.arange(size) + 0.5) / size * 2.0 - 1.0
    uu, vv = np.meshgrid(s, s)  # vv top->bottom
    faces = np.zeros((6, size, size, env.shape[-1]), np.float32)
    rot = _quat_matrix(rotation) if rotation is not None else None
    for f, (fw, ua, va) in enumerate(_CUBE_FACE_AXES):
        d = (np.asarray(fw, np.float64)[None, None, :]
             + uu[..., None] * np.asarray(ua, np.float64)
             + vv[..., None] * np.asarray(va, np.float64))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        if rot is not None:
            d = d @ rot.T
        faces[f] = _sample_equirect_np(env, d)
    return faces


def equirect_from_cube_faces(faces, height: int, rotation=None) -> np.ndarray:
    """(height, 2*height, 3) equirect map resampled from (6, S, S, 3) cube faces.
    `rotation` (wxyz) is the environment's authored rotation (applied forward)."""
    faces = np.asarray(faces, np.float32)
    h, w = height, 2 * height
    d = _dirs_equirect_np(h, w)
    if rotation is not None:
        d = d @ _quat_matrix(rotation)  # inverse-rotate the lookup
    ax, ay, az = d[..., 0], d[..., 1], d[..., 2]
    aax, aay, aaz = np.abs(ax), np.abs(ay), np.abs(az)
    size = faces.shape[1]
    out = np.zeros((h, w, faces.shape[-1]), np.float32)
    # face selection by dominant axis
    face_id = np.where(
        (aax >= aay) & (aax >= aaz), np.where(ax > 0, 0, 1),
        np.where(aay >= aaz, np.where(ay > 0, 2, 3), np.where(az > 0, 4, 5)))
    for f, (fw, ua, va) in enumerate(_CUBE_FACE_AXES):
        m = face_id == f
        if not m.any():
            continue
        dm = d[m]
        denom = dm @ np.asarray(fw, np.float64)
        u = (dm @ np.asarray(ua, np.float64)) / denom
        v = (dm @ np.asarray(va, np.float64)) / denom
        iu = np.clip(((u + 1) * 0.5 * size).astype(np.int64), 0, size - 1)
        iv = np.clip(((v + 1) * 0.5 * size).astype(np.int64), 0, size - 1)
        out[m] = faces[f, iv, iu]
    return out


def _quat_matrix(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    n = max(np.sqrt(w * w + x * x + y * y + z * z), 1e-30)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def sh9_irradiance_coefficients(env) -> np.ndarray:
    """(9, 3) l<=2 spherical-harmonic projection of an equirect radiance map — the
    irradianceCoefficients payload of EXT_lights_image_based."""
    env = np.asarray(env, np.float64)
    h, w = env.shape[0], env.shape[1]
    d = _dirs_equirect_np(h, w)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    # solid angle per texel: sin(theta) dtheta dphi
    theta = (np.arange(h) + 0.5) / h * np.pi
    domega = (np.sin(theta)[:, None] * (np.pi / h) * (2 * np.pi / w)
              * np.ones((1, w)))
    y00 = 0.282095 * np.ones_like(x)
    basis = np.stack([
        y00, 0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z, 0.315392 * (3 * z * z - 1),
        1.092548 * x * z, 0.546274 * (x * x - y * y),
    ], axis=-1)  # (h, w, 9)
    return np.einsum("hwn,hwc,hw->nc", basis, env[..., :3], domega)


def equirect_from_sh9(coeffs, height: int = 16) -> np.ndarray:
    """Low-frequency equirect reconstruction from SH9 coefficients (fallback when a
    document carries irradianceCoefficients but no specular images)."""
    coeffs = np.asarray(coeffs, np.float64).reshape(9, -1)
    h, w = height, 2 * height
    d = _dirs_equirect_np(h, w)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    basis = np.stack([
        0.282095 * np.ones_like(x), 0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z, 0.315392 * (3 * z * z - 1),
        1.092548 * x * z, 0.546274 * (x * x - y * y),
    ], axis=-1)
    return np.maximum(basis @ coeffs, 0.0).astype(np.float32)
