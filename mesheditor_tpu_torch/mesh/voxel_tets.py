"""Voxel-grid tetrahedralization of a closed triangle surface.

`generate_tets` fills the surface's interior with a uniform grid of cells, each Kuhn-split
into 6 tets — the framework's general-mesh stand-in for the reference's constrained-
Delaunay mesher (tetra::Tetrahedralize, src/mesh/Tetrahedralize.cpp) where the native
Delaunay mesher (mesh/cdt.py) cannot mesh a surface. Inside/outside is ray-crossing parity
along x, computed per grid line (fully vectorized over triangles). Boundary grid vertices
are optionally snapped toward the surface to soften the staircase.

Limitations vs CDT (documented, by design for now): the input surface is not preserved
exactly, and walls thinner than ~2 grid cells vanish — fine for chunky solids, not for
thin shells. `resolution` counts grid cells across the longest bounding-box edge.
"""

from __future__ import annotations

import numpy as np

from ..types import TetMesh
from .primitives import _KUHN_CORNERS

VOXEL_MESHES = 0  # meshes this mesher answered (mesh/cdt.py counts the native mesher's)


def _line_crossings(points, tris, ys, zs):
    """For every (y, z) grid line, the sorted x positions where it pierces the surface.
    Returns a dict {(iy, iz): np.ndarray of crossing xs}."""
    v = points[tris]  # (T, 3, 3)
    # Project to yz; precompute edge setup for barycentric point-in-triangle tests.
    a, b, c = v[:, 0], v[:, 1], v[:, 2]
    d1 = b - a
    d2 = c - a
    denom = d1[:, 1] * d2[:, 2] - d2[:, 1] * d1[:, 2]  # 2x signed area in yz
    ok = np.abs(denom) > 1e-30  # x-parallel triangles never cross an x-line transversally
    crossings: dict[tuple[int, int], list] = {}
    yy, zz = np.meshgrid(ys, zs, indexing="ij")
    lines = np.stack([yy.reshape(-1), zz.reshape(-1)], axis=1)  # (L, 2)
    chunk = max(1, int(2e7) // max(len(lines), 1))
    t_idx = np.flatnonzero(ok)
    for s in range(0, len(t_idx), chunk):
        ts = t_idx[s : s + chunk]
        av, d1v, d2v, den = a[ts], d1[ts], d2[ts], denom[ts]
        py = lines[None, :, 0] - av[:, None, 1]  # (Tc, L)
        pz = lines[None, :, 1] - av[:, None, 2]
        u = (py * d2v[:, None, 2] - pz * d2v[:, None, 1]) / den[:, None]
        w = (pz * d1v[:, None, 1] - py * d1v[:, None, 2]) / den[:, None]
        hit = (u >= 0) & (w >= 0) & (u + w <= 1)
        ti, li = np.nonzero(hit)
        if ti.size == 0:
            continue
        x = av[ti, 0] + u[ti, li] * d1v[ti, 0] + w[ti, li] * d2v[ti, 0]
        for line, xv in zip(li, x):
            crossings.setdefault((int(line) // len(zs), int(line) % len(zs)), []).append(xv)
    return {k: np.sort(np.asarray(v)) for k, v in crossings.items()}


def generate_tets(
    points: np.ndarray,
    tris: np.ndarray,
    resolution: int = 24,
    snap: bool = True,
) -> TetMesh:
    """Tet-mesh the interior of a closed, non-self-intersecting triangle surface."""
    global VOXEL_MESHES
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    extent = hi - lo
    h = float(extent.max()) / resolution
    if h <= 0:
        raise ValueError("degenerate surface bounds")
    pad = 0.5 * h
    lo = lo - pad
    dims = np.maximum(np.ceil((extent + 2 * pad) / h).astype(int), 1)  # cells per axis
    nx, ny, nz = (int(d) for d in dims)
    xs = lo[0] + np.arange(nx + 1) * h
    ys = lo[1] + np.arange(ny + 1) * h
    zs = lo[2] + np.arange(nz + 1) * h

    # Jitter the ray origins by tiny irrational offsets so no grid line hits a triangle
    # edge or vertex exactly (a shared edge would double-count and flip the parity) —
    # the cheap stand-in for the reference's symbolic perturbation (Predicates.h SoS).
    jit_y = h * 1e-5 * np.sqrt(2.0)
    jit_z = h * 1e-5 * np.sqrt(3.0)
    crossings = _line_crossings(points, tris, ys + jit_y, zs + jit_z)
    inside = np.zeros((nx + 1, ny + 1, nz + 1), dtype=bool)
    for (iy, iz), cx in crossings.items():
        # Parity: a vertex is inside when an odd number of crossings lie beyond it.
        counts = cx.size - np.searchsorted(cx, xs)
        inside[:, iy, iz] = (counts % 2) == 1

    # A cell is solid when all 8 corners are inside.
    corners = inside
    solid = (
        corners[:-1, :-1, :-1] & corners[1:, :-1, :-1] & corners[:-1, 1:, :-1]
        & corners[1:, 1:, :-1] & corners[:-1, :-1, 1:] & corners[1:, :-1, 1:]
        & corners[:-1, 1:, 1:] & corners[1:, 1:, 1:]
    )
    ci, cj, ck = np.nonzero(solid)
    if ci.size == 0:
        raise ValueError(
            "no interior cells at this resolution (thin-walled input? raise `resolution` "
            "or pre-thicken; exact-surface CDT meshing is the planned replacement)"
        )

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    corner_ids = np.stack(
        [
            vid(ci, cj, ck), vid(ci + 1, cj, ck), vid(ci, cj + 1, ck), vid(ci + 1, cj + 1, ck),
            vid(ci, cj, ck + 1), vid(ci + 1, cj, ck + 1), vid(ci, cj + 1, ck + 1), vid(ci + 1, cj + 1, ck + 1),
        ],
        axis=-1,
    )  # (cells, 8)
    tets = corner_ids[:, _KUHN_CORNERS].reshape(-1, 4)

    gx, gy, gzn = np.meshgrid(xs, ys, zs, indexing="ij")
    grid_points = np.stack([gx, gy, gzn], axis=-1).reshape(-1, 3)

    # Compact to used vertices.
    used, remap = np.unique(tets.reshape(-1), return_inverse=True)
    out_points = grid_points[used]
    out_tets = remap.reshape(-1, 4).astype(np.uint32)

    if snap:
        # Pull boundary vertices (those not shared by 8 solid cells) toward the nearest
        # surface point, limited to half a cell so tets stay valid.
        out_points = _snap_boundary(out_points, used, inside.shape, solid, points, tris, 0.45 * h)

    VOXEL_MESHES += 1
    return TetMesh(points=out_points, tets=out_tets)


def _snap_boundary(out_points, used_ids, grid_shape, solid, surf_points, tris, max_dist):
    nxp, nyp, nzp = grid_shape
    ny1, nz1 = nyp, nzp
    i = used_ids // (ny1 * nz1)
    j = (used_ids // nz1) % ny1
    k = used_ids % nz1
    # A vertex is interior when all up-to-8 adjacent cells are solid.
    nx, ny, nz = solid.shape
    adj_all = np.ones(used_ids.shape, dtype=bool)
    for di in (0, -1):
        for dj in (0, -1):
            for dk in (0, -1):
                ci = i + di
                cj = j + dj
                ck = k + dk
                valid = (ci >= 0) & (ci < nx) & (cj >= 0) & (cj < ny) & (ck >= 0) & (ck < nz)
                s = np.zeros(used_ids.shape, dtype=bool)
                s[valid] = solid[ci[valid], cj[valid], ck[valid]]
                adj_all &= s
    boundary = ~adj_all
    if not boundary.any():
        return out_points
    bpts = out_points[boundary]
    # Nearest surface point per boundary vertex (closest point on each triangle's plane is
    # approximated by the nearest of a dense sampling: triangle vertices + centroids —
    # adequate at snap distances under half a cell).
    v = surf_points[tris]
    samples = np.concatenate([surf_points, v.mean(axis=1)], axis=0)
    chunk = max(1, int(2e7) // max(samples.shape[0], 1))
    moved = bpts.copy()
    for s in range(0, bpts.shape[0], chunk):
        d = ((bpts[s : s + chunk, None, :] - samples[None, :, :]) ** 2).sum(axis=2)
        nearest = samples[np.argmin(d, axis=1)]
        delta = nearest - bpts[s : s + chunk]
        dist = np.linalg.norm(delta, axis=1, keepdims=True)
        scale = np.minimum(1.0, max_dist / np.maximum(dist, 1e-30))
        moved[s : s + chunk] = bpts[s : s + chunk] + delta * scale
    out = out_points.copy()
    out[boundary] = moved
    return out
