"""Triangle-mesh queries: closest point, per-vertex mean curvature, enclosed volume.

The reference's MeshBvh (src/mesh/MeshBvh.h:32-57) feeds the Hertz contact curvature at
strike sites (AudioSystem.cpp:291-308) and the acceleration-noise amplitude via enclosed
volume (:745-748). Here the closest-point query is a vectorized median-split BVH walk;
curvature is the discrete mean-curvature normal (cotangent Laplacian over vertex normals);
volume is the divergence theorem over signed tet volumes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MeshBvh:
    positions: np.ndarray  # (n, 3)
    triangles: np.ndarray  # (m, 3)
    # Flat BVH: nodes as (lo, hi, left, right, start, count); leaves have left == -1.
    bounds_lo: np.ndarray
    bounds_hi: np.ndarray
    left: np.ndarray
    right: np.ndarray
    start: np.ndarray
    count: np.ndarray
    order: np.ndarray  # triangle permutation


def build_bvh(positions: np.ndarray, triangles: np.ndarray, leaf_size: int = 8) -> MeshBvh:
    positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    triangles = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    centers = positions[triangles].mean(axis=1)
    m = triangles.shape[0]
    order = np.arange(m)

    lo_list, hi_list, left_list, right_list, start_list, count_list = [], [], [], [], [], []

    def node(idx_lo, idx_hi):
        me = len(lo_list)
        tri_ids = order[idx_lo:idx_hi]
        v = positions[triangles[tri_ids]].reshape(-1, 3)
        lo_list.append(v.min(axis=0))
        hi_list.append(v.max(axis=0))
        left_list.append(-1)
        right_list.append(-1)
        start_list.append(idx_lo)
        count_list.append(idx_hi - idx_lo)
        if idx_hi - idx_lo > leaf_size:
            c = centers[tri_ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            key = np.argsort(c[:, axis], kind="stable")
            order[idx_lo:idx_hi] = tri_ids[key]
            mid = (idx_lo + idx_hi) // 2
            left_list[me] = node(idx_lo, mid)
            right_list[me] = node(mid, idx_hi)
        return me

    import sys

    rec = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec, 10000))
    node(0, m)
    sys.setrecursionlimit(rec)
    return MeshBvh(
        positions, triangles,
        np.asarray(lo_list), np.asarray(hi_list),
        np.asarray(left_list), np.asarray(right_list),
        np.asarray(start_list), np.asarray(count_list), order,
    )


def _closest_on_triangles(p: np.ndarray, tri_pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Closest points of `p` on each triangle (t, 3, 3) -> (points (t,3), dist2 (t,))."""
    a, b, c = tri_pts[:, 0], tri_pts[:, 1], tri_pts[:, 2]
    ab = b - a
    ac = c - a
    ap = p[None, :] - a
    d1 = (ab * ap).sum(1)
    d2 = (ac * ap).sum(1)
    bp = p[None, :] - b
    d3 = (ab * bp).sum(1)
    d4 = (ac * bp).sum(1)
    cp = p[None, :] - c
    d5 = (ab * cp).sum(1)
    d6 = (ac * cp).sum(1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    v = np.where(np.abs(denom) > 1e-300, vb / np.where(denom == 0, 1, denom), 0.0)
    w = np.where(np.abs(denom) > 1e-300, vc / np.where(denom == 0, 1, denom), 0.0)
    out = a + v[:, None] * ab + w[:, None] * ac  # interior candidate
    # Vertex regions.
    out = np.where(((d1 <= 0) & (d2 <= 0))[:, None], a, out)
    out = np.where(((d3 >= 0) & (d4 <= d3))[:, None], b, out)
    out = np.where(((d6 >= 0) & (d5 <= d6))[:, None], c, out)
    # Edge regions.
    t_ab = np.clip(d1 / np.where(d1 - d3 == 0, 1, d1 - d3), 0, 1)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    out = np.where(on_ab[:, None], a + t_ab[:, None] * ab, out)
    t_ac = np.clip(d2 / np.where(d2 - d6 == 0, 1, d2 - d6), 0, 1)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    out = np.where(on_ac[:, None], a + t_ac[:, None] * ac, out)
    t_bc = np.clip((d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1, (d4 - d3) + (d5 - d6)), 0, 1)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    out = np.where(on_bc[:, None], b + t_bc[:, None] * (c - b), out)
    dist2 = ((out - p[None, :]) ** 2).sum(1)
    return out, dist2


def closest_point(bvh: MeshBvh, p: np.ndarray) -> tuple[np.ndarray, int, float]:
    """(closest point, triangle index, distance) via best-first BVH descent."""
    p = np.asarray(p, dtype=np.float64)
    best_d2 = np.inf
    best_pt = None
    best_tri = -1
    stack = [0]
    while stack:
        ni = stack.pop()
        lo, hi = bvh.bounds_lo[ni], bvh.bounds_hi[ni]
        gap = np.maximum(lo - p, 0) + np.maximum(p - hi, 0)
        if (gap @ gap) >= best_d2:
            continue
        if bvh.left[ni] < 0:
            ids = bvh.order[bvh.start[ni] : bvh.start[ni] + bvh.count[ni]]
            pts, d2 = _closest_on_triangles(p, bvh.positions[bvh.triangles[ids]])
            k = int(np.argmin(d2))
            if d2[k] < best_d2:
                best_d2 = float(d2[k])
                best_pt = pts[k]
                best_tri = int(ids[k])
        else:
            stack.append(int(bvh.left[ni]))
            stack.append(int(bvh.right[ni]))
    return best_pt, best_tri, float(np.sqrt(best_d2))


def enclosed_volume(positions: np.ndarray, triangles: np.ndarray) -> float:
    """Signed volume via the divergence theorem (positive for outward-wound closed
    surfaces) — drives the acceleration-noise amplitude (AudioSystem.cpp:745-748)."""
    v = np.asarray(positions, dtype=np.float64)[np.asarray(triangles, dtype=np.int64)]
    return float(np.einsum("ti,ti->", v[:, 0], np.cross(v[:, 1], v[:, 2])) / 6.0)


def vertex_mean_curvature(positions: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Per-vertex mean curvature H (1/m) from the cotangent Laplace-Beltrami of the
    positions: H = |L x| / (2 * A_mixed), signed by the vertex normal. Feeds the object's
    contribution to the Hertz combined curvature at strike sites."""
    pos = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    tri = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    n = pos.shape[0]
    lap = np.zeros_like(pos)
    area = np.zeros(n)
    vnormal = np.zeros_like(pos)
    for k in range(3):
        i = tri[:, k]
        j = tri[:, (k + 1) % 3]
        o = tri[:, (k + 2) % 3]
        # cot at vertex o for edge (i, j)
        u = pos[i] - pos[o]
        v = pos[j] - pos[o]
        cross = np.cross(u, v)
        cross_norm = np.linalg.norm(cross, axis=1)
        cot = (u * v).sum(1) / np.maximum(cross_norm, 1e-30)
        w = 0.5 * cot
        d = pos[j] - pos[i]
        np.add.at(lap, i, w[:, None] * d)
        np.add.at(lap, j, -w[:, None] * d)
        np.add.at(area, i, cross_norm / 6.0)  # third of the triangle area per corner
        np.add.at(vnormal, i, cross)
    h_vec = lap / (2.0 * np.maximum(area, 1e-30))[:, None]
    vn = vnormal / np.maximum(np.linalg.norm(vnormal, axis=1, keepdims=True), 1e-30)
    # Calibrated against spheres: |h_vec| = 1/R with this area accumulation. Signed so
    # convex regions (curvature vector against the outward normal) are positive.
    sign = -np.sign((h_vec * vn).sum(1))
    return np.linalg.norm(h_vec, axis=1) * np.where(sign == 0, 1.0, sign)
