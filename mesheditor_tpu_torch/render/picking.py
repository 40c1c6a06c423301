"""Picking and box selection against the rendered ID buffers (counterpart of
mesheditor_tpu/render/picking.py).

The reference resolves clicks and box-selects with GPU compute passes over per-pixel
selection fragments ("GPU-accelerated mouse interactions, no CPU acceleration
structures", README.md:43; src/selection/SelectionGpu.h:75-81, ObjectPick/ElementPick/
BoxSelect.comp). Here the rasterizer's G-buffer IS that fragment buffer: a click reads
one pixel of the triangle-id image from the device, element resolution is barycentric
math on the hit, and box selection reduces the rect on the device to its unique ids;
only those ids come to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .raster import screen_coords


def _pixel_tri(gbuf, x: int, y: int) -> int:
    return int(gbuf.tri[int(y), int(x)].item())


def pick_object(gbuf, tri_obj, x: int, y: int) -> int:
    """Object id under pixel (x, y); -1 on background."""
    tri = _pixel_tri(gbuf, x, y)
    if tri < 0:
        return -1
    return int(tri_obj[tri])


def pick_element(gbuf, tris, x: int, y: int, kind: str = "face"):
    """Resolve the element under a pixel: 'face' -> triangle index,
    'vertex' -> nearest corner (max barycentric), 'edge' -> (va, vb) of the nearest
    edge (the two largest barycentrics — the edge opposite the smallest)."""
    tri = _pixel_tri(gbuf, x, y)
    if tri < 0:
        return None
    if kind == "face":
        return tri
    tris = np.asarray(tris).reshape(-1, 3)
    bary = gbuf.bary[int(y), int(x)].cpu().numpy()
    if kind == "vertex":
        return int(tris[tri, int(np.argmax(bary))])
    if kind == "edge":
        lo = int(np.argmin(bary))
        a, b = [int(tris[tri, k]) for k in range(3) if k != lo]
        return (min(a, b), max(a, b))
    raise ValueError(f"unknown element kind {kind!r}")


def _rect_tris(gbuf, x0, y0, x1, y1) -> torch.Tensor:
    """Unique visible triangle ids inside the rect (inclusive), reduced on the device."""
    region = gbuf.tri[y0:y1 + 1, x0:x1 + 1]
    return torch.unique(region[region >= 0])


def box_select(gbuf, tri_obj, x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """Object ids with any visible pixel inside the rect (sorted, unique). `tri_obj` is
    a host array or a tensor on the G-buffer's device."""
    x0, x1 = sorted((int(x0), int(x1)))
    y0, y1 = sorted((int(y0), int(y1)))
    hit = _rect_tris(gbuf, x0, y0, x1, y1)
    if hit.numel() == 0:
        return np.zeros(0, np.int64)
    tri_obj = torch.as_tensor(tri_obj, device=hit.device)
    return torch.unique(tri_obj[hit.long()]).cpu().numpy()


def box_select_vertices(clip, width: int, height: int, x0: int, y0: int, x1: int,
                        y1: int, gbuf=None, tris=None) -> np.ndarray:
    """Vertex ids whose projection falls inside the rect (reference BoxSelect.comp
    against element bitsets). With a G-buffer, occluded vertices are filtered out by
    requiring the vertex to belong to some visible triangle in the rect."""
    x0, x1 = sorted((int(x0), int(x1)))
    y0, y1 = sorted((int(y0), int(y1)))
    sc = screen_coords(clip, width, height)
    w = np.asarray(clip)[:, 3]
    inside = (
        (sc[:, 0] >= x0) & (sc[:, 0] <= x1) & (sc[:, 1] >= y0) & (sc[:, 1] <= y1)
        & (w > 1e-6)
    )
    ids = np.nonzero(inside)[0]
    if gbuf is not None and tris is not None and ids.size:
        vis_tris = _rect_tris(gbuf, x0, y0, x1, y1).cpu().numpy()
        vis_verts = np.unique(np.asarray(tris).reshape(-1, 3)[vis_tris])
        ids = ids[np.isin(ids, vis_verts)]
    return ids
