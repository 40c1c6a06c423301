"""Z-buffered triangle rasterizer in PyTorch (counterpart of mesheditor_tpu/render/raster.py).

The reference records multi-draw-indirect Vulkan passes with GPU culling
(src/viewport/ViewportRenderGpu.h:14-43); the JAX package runs one jitted scan over
triangle chunks. Here the scan is a Python loop over chunks on the device: each step
evaluates edge functions for a chunk of triangles against every pixel center (dense
broadcast work, an (H, W, C) tensor per temporary) and z-merges into the G-buffer. Output
is a deferred-shading G-buffer — depth, triangle id, perspective-correct barycentrics —
the same buffers the reference's selection compute passes consume
(src/selection/SelectionGpu.h:75-81).

The G-buffer does not depend on the chunk size: every per-pixel value is elementwise in
its triangle, the chunk-internal resolve takes the first minimum (`torch.argmin`, as
`jnp.argmin`) and the merge is a strict `<`, so the earliest triangle wins exact ties.
The memory does: a step holds about BYTES_PER_PAIR bytes per pixel-triangle pair, so
`frame_chunk` sizes the chunk to the frame under a budget of the device's free memory.

Near-plane handling: `clip_near` replaces plane-crossing triangles with their clipped
fans on host (a handful per frame), so the rasterizer never sees a w <= eps vertex;
fully-behind triangles drop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device


class GBuffer(NamedTuple):
    depth: torch.Tensor  # (H, W) float32 ndc z in [-1, 1]; +inf where empty
    tri: torch.Tensor    # (H, W) int32 triangle index; -1 where empty
    bary: torch.Tensor   # (H, W, 3) float32 perspective-correct barycentrics


def _edge(ax, ay, bx, by, px, py):
    """Signed area of (a, b, p) parallelogram — the rasterizer edge function."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _rasterize_chunk(clip, idx, first_id, px, py, width, height, cull_back, gbuf):
    """Rasterize the triangles `idx` (C, 3) and z-merge them into `gbuf` in place."""
    depth, tri, bary = gbuf
    v = clip[idx]  # (C, 3, 4)
    w = v[..., 3]
    valid = (w > 1e-6).all(dim=1)  # reject near-plane crossers
    w = torch.where(w == 0, 1.0, w)
    ndc = v[..., :3] / w[..., None]
    sx = (ndc[..., 0] + 1.0) * (0.5 * width)  # (C, 3)
    sy = (1.0 - ndc[..., 1]) * (0.5 * height)
    nz = ndc[..., 2]

    area = _edge(sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2])  # (C,)
    valid &= area != 0.0
    if cull_back:
        # GL CCW front faces flip to clockwise under the screen y-flip.
        valid &= area < 0.0
    inv_area = 1.0 / area

    # Barycentrics at every pixel center: (H, W, C) each, scaled in place.
    b0 = _edge(sx[:, 1], sy[:, 1], sx[:, 2], sy[:, 2], px, py).mul_(inv_area)
    b1 = _edge(sx[:, 2], sy[:, 2], sx[:, 0], sy[:, 0], px, py).mul_(inv_area)
    b2 = _edge(sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1], px, py).mul_(inv_area)
    cover = b0 >= 0
    cover &= b1 >= 0
    cover &= b2 >= 0
    cover &= valid

    z = b0 * nz[:, 0]
    z += b1 * nz[:, 1]
    z += b2 * nz[:, 2]
    cover &= z >= -1.0
    cover &= z <= 1.0
    z.masked_fill_(~cover, float("inf"))
    del cover

    # Chunk-internal z-resolve (first minimum), then a strict-< merge into the buffer.
    k = z.argmin(dim=-1, keepdim=True)  # (H, W, 1)
    zk = z.gather(-1, k)[..., 0]
    del z
    better = zk < depth

    # Perspective-correct barycentrics of the winner only: every value is elementwise in
    # its triangle, so gathering first gives the bits the full (H, W, C) form would.
    iw = (1.0 / w)[k[..., 0]]  # (H, W, 3)
    p0 = b0.gather(-1, k)[..., 0] * iw[..., 0]
    p1 = b1.gather(-1, k)[..., 0] * iw[..., 1]
    p2 = b2.gather(-1, k)[..., 0] * iw[..., 2]
    psum = p0 + p1 + p2
    psum = torch.where(psum == 0, 1.0, psum)
    new_bary = torch.stack([p0 / psum, p1 / psum, p2 / psum], dim=-1)

    depth.copy_(torch.where(better, zk, depth))
    tri.copy_(torch.where(better, (k[..., 0] + first_id).to(torch.int32), tri))
    bary.copy_(torch.where(better[..., None], new_bary, bary))


# Peak bytes of one chunk step per pixel-triangle pair: three barycentric rows and the
# depth (float32), the coverage mask and the product being summed into the depth. The
# card's peaks at 1920x1440 (0.66 / 3.69 / 14.07 GiB at chunk 8 / 64 / 256) rise by 21.0
# bytes per pair. Per pixel, the G-buffer adds GBUFFER_BYTES_PER_PIXEL.
BYTES_PER_PAIR = 21
GBUFFER_BYTES_PER_PIXEL = 20  # depth f32 + triangle id i32 + 3 barycentrics f32
MAX_CHUNK = 256
CPU_BUDGET_BYTES = 4 << 30


def raster_peak_bytes(height: int, width: int, chunk: int) -> int:
    """The memory `rasterize` adds at its peak for a (height, width) frame at `chunk`: the
    G-buffer and one chunk step's temporaries."""
    return int(height) * int(width) * (GBUFFER_BYTES_PER_PIXEL + BYTES_PER_PAIR * int(chunk))


def derive_chunk(height: int, width: int, budget: int) -> int:
    """The largest power of two up to MAX_CHUNK whose step's temporaries
    (BYTES_PER_PAIR x height x width x chunk) fit in `budget` bytes; at least 1."""
    fit = int(budget) // (BYTES_PER_PAIR * int(height) * int(width))
    chunk = max(min(MAX_CHUNK, fit), 1)
    return 1 << (chunk.bit_length() - 1)


def frame_chunk(chunk, height: int, width: int, device) -> int:
    """`chunk` when the caller set one, else `derive_chunk` under a budget of half the
    card's free memory now (a fixed CPU_BUDGET_BYTES on the CPU). height and width are the
    rasterized (supersampled) size."""
    if chunk is not None:
        return int(chunk)
    dev = torch.device(device)
    if dev.type == "cuda":
        budget = torch.cuda.mem_get_info(dev)[0] // 2
    else:
        budget = CPU_BUDGET_BYTES
    return derive_chunk(height, width, budget)


def rasterize(clip, tris, width: int, height: int, chunk: int = 8,
              cull_back: bool = False, device="cuda") -> GBuffer:
    """Rasterize clip-space triangles into a (height, width) G-buffer on `device`.

    clip: (N, 4) float clip-space positions (view_projection @ [pos, 1]), numpy or a
    tensor. tris: (T, 3) int vertex indices. Padded internally to a chunk multiple with
    degenerate (0,0,0) triangles, which are zero-area and self-reject.
    """
    dev = resolve_device(device)
    clip = torch.as_tensor(clip, dtype=torch.float32, device=dev)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    chunk = int(chunk)
    t = tris.shape[0]
    if t == 0:
        tris = np.zeros((chunk, 3), np.int64)
        if clip.shape[0] == 0:
            clip = torch.zeros((1, 4), dtype=torch.float32, device=dev)
    elif t % chunk:
        tris = np.concatenate([tris, np.zeros((chunk - t % chunk, 3), np.int64)])
    tris = torch.as_tensor(tris, device=dev)
    width, height = int(width), int(height)
    # Pixel centers, shaped to broadcast against per-triangle (C,) rows: (1, W, 1), (H, 1, 1).
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None, None]
    gbuf = GBuffer(
        torch.full((height, width), float("inf"), dtype=torch.float32, device=dev),
        torch.full((height, width), -1, dtype=torch.int32, device=dev),
        torch.zeros((height, width, 3), dtype=torch.float32, device=dev),
    )
    for first in range(0, tris.shape[0], chunk):
        _rasterize_chunk(clip, tris[first:first + chunk], first, px, py, width, height,
                         bool(cull_back), gbuf)
    # Padding triangles are zero-area and never shade; ids past the real count can't
    # appear, so tri is already a faithful pick buffer.
    return gbuf


def clip_near(clip, tris, eps: float = 1e-4):
    """Host-side near-plane clipping (Sutherland-Hodgman against w = eps in clip
    space): triangles crossing the plane are replaced by their clipped fan; fully
    behind ones drop. Keeps the device rasterizer branch-free — crossers are a handful
    per frame, so the host pass is cheap.

    Returns (tris_out, tri_src, new_verts) where `tri_src` maps every output triangle
    to its source triangle id (picking stays in source-triangle space) and `new_verts`
    is a (K, 3) array of (parent_a, parent_b, t) lerp recipes for the K vertices
    appended past the original count — clip space is linear in world space, so the
    same t interpolates world attributes."""
    clip = np.asarray(clip, np.float64)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    if tris.shape[0] == 0:
        return tris.astype(np.int32), np.arange(0, dtype=np.int32), np.zeros((0, 3))
    w = clip[:, 3]
    inside = w[tris] > eps  # (T, 3)
    n_in = inside.sum(axis=1)
    keep = n_in == 3
    crossing = np.flatnonzero((n_in > 0) & (n_in < 3))
    if crossing.size == 0:
        kept = np.flatnonzero(keep)
        return tris[kept].astype(np.int32), kept.astype(np.int32), np.zeros((0, 3))

    out_tris = [tris[keep]]
    out_src = [np.flatnonzero(keep)]
    new_verts = []
    next_id = clip.shape[0]

    def cut(a, b):
        # Intersection of edge (a, b) with w = eps; t from linearity of w in clip space.
        nonlocal next_id
        t = (eps - w[a]) / (w[b] - w[a])
        new_verts.append((a, b, float(t)))
        next_id += 1
        return next_id - 1

    for ti in crossing:
        poly = []
        ids = tris[ti]
        ins = inside[ti]
        for k in range(3):
            a, b = ids[k], ids[(k + 1) % 3]
            if ins[k]:
                poly.append(int(a))
            if ins[k] != ins[(k + 1) % 3]:
                poly.append(cut(int(a), int(b)))
        for k in range(1, len(poly) - 1):  # fan
            out_tris.append(np.array([[poly[0], poly[k], poly[k + 1]]]))
            out_src.append(np.array([ti]))
    return (np.concatenate(out_tris).astype(np.int32),
            np.concatenate(out_src).astype(np.int32),
            np.asarray(new_verts, np.float64).reshape(-1, 3))


def project_points(mvp, positions, device="cuda") -> torch.Tensor:
    """(N, 3) world points -> (N, 4) float32 clip space under a 4x4 MVP, on `device`.

    Exact float32 multiply-adds, never a matmul: each output is (x m0 + y m1) + (z m2 + m3)
    with every product rounded, the order in which the JAX package's dot sums its four
    terms, so both packages give the same bits."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(positions, np.float32).reshape(-1, 3), device=dev)
    m = torch.as_tensor(np.asarray(mvp, np.float32), device=dev)
    return ((p[:, 0:1] * m[:, 0] + p[:, 1:2] * m[:, 1])
            + (p[:, 2:3] * m[:, 2] + m[:, 3]))


def screen_coords(clip, width: int, height: int) -> np.ndarray:
    """Clip -> pixel coordinates (x right, y down), for host-side selection math."""
    clip = np.asarray(clip, np.float64)
    w = np.where(clip[:, 3] == 0, 1.0, clip[:, 3])
    ndc = clip[:, :3] / w[:, None]
    return np.stack([(ndc[:, 0] + 1) * 0.5 * width, (1 - ndc[:, 1]) * 0.5 * height], 1)
