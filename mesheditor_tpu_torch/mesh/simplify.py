"""Surface simplification: quadric edge-collapse with a vertex-clustering fallback.

Fills the role of the reference's meshoptimizer-based quadric collapse on the
solve-input path (SimplifySurface, src/mesh/Tets.cpp:249-261): lower `ratio` ->
coarser surface -> faster tetrahedralization/solve. Matches the reference's shape:
a quadric collapse to `ratio * len(tris)` triangles, with a defect-avoiding retry
(Tets.cpp:198-226 locks defect vertices; here collapses that would flip a face or
break manifoldness are rejected outright, and a grid-clustering pass backstops the
rare mesh the collapse loop cannot take to target).
"""

from __future__ import annotations

import heapq

import numpy as np


def _vertex_quadrics(positions: np.ndarray, tris: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Garland-Heckbert per-vertex quadrics: area-weighted sum of the face plane
    quadrics p p^T (p = (n, d), n unit normal, d = -n.v0), plus a strong
    perpendicular constraint quadric per boundary edge so open borders keep shape.
    Also returns the accumulated plane weight per vertex, so cost/weight estimates the
    squared normal-distance error of a collapse (tangential motion is free)."""
    v0, v1, v2 = (positions[tris[:, k]] for k in range(3))
    cross = np.cross(v1 - v0, v2 - v0)
    area2 = np.linalg.norm(cross, axis=1)
    ok = area2 > 1e-30
    n = np.zeros_like(cross)
    n[ok] = cross[ok] / area2[ok, None]
    d = -(n * v0).sum(axis=1)
    p = np.concatenate([n, d[:, None]], axis=1)  # (T, 4)
    kq = p[:, :, None] * p[:, None, :] * (0.5 * area2)[:, None, None]  # (T, 4, 4)

    q = np.zeros((positions.shape[0], 4, 4))
    w = np.zeros(positions.shape[0])
    for k in range(3):
        np.add.at(q, tris[:, k], kq)
        np.add.at(w, tris[:, k], 0.5 * area2)

    # Boundary edges: a plane through the edge, perpendicular to its face.
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    ekey = np.sort(edges, axis=1)
    _, inv, counts = np.unique(ekey, axis=0, return_inverse=True, return_counts=True)
    boundary = counts[inv] == 1
    if boundary.any():
        be = edges[boundary]
        fn = np.repeat(n, 3, axis=0).reshape(3, -1, 3).transpose(1, 0, 2).reshape(-1, 3)[
            boundary
        ]
        a, b = positions[be[:, 0]], positions[be[:, 1]]
        edir = b - a
        elen = np.linalg.norm(edir, axis=1)
        good = elen > 1e-30
        pn = np.cross(edir, fn)
        pl = np.linalg.norm(pn, axis=1)
        good &= pl > 1e-30
        pn[good] = pn[good] / pl[good, None]
        pd = -(pn * a).sum(axis=1)
        pp = np.concatenate([pn, pd[:, None]], axis=1)
        bw = np.where(good, elen * elen, 0.0)
        bq = pp[:, :, None] * pp[:, None, :] * bw[:, None, None]
        np.add.at(q, be[:, 0], bq)
        np.add.at(q, be[:, 1], bq)
        np.add.at(w, be[:, 0], bw)
        np.add.at(w, be[:, 1], bw)
    return q, w


def _optimal_point(q: np.ndarray, a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, float]:
    """Collapse target for the pooled quadric: the quadric minimum when well
    conditioned, else the best of (midpoint, a, b)."""
    A = q[:3, :3]
    rhs = -q[:3, 3]
    try:
        if np.linalg.cond(A) < 1e8:
            v = np.linalg.solve(A, rhs)
        else:
            raise np.linalg.LinAlgError
    except np.linalg.LinAlgError:
        cands = np.stack([0.5 * (a + b), a, b])
        h = np.concatenate([cands, np.ones((3, 1))], axis=1)
        costs = np.einsum("ci,ij,cj->c", h, q, h)
        k = int(np.argmin(costs))
        return cands[k], float(costs[k])
    h = np.concatenate([v, [1.0]])
    return v, float(h @ q @ h)


def _quadric_collapse(
    positions: np.ndarray, tris: np.ndarray, target_tris: int, max_err: float
) -> tuple[np.ndarray, np.ndarray] | None:
    """Greedy heap-driven edge collapse to `target_tris`, bounded by `max_err` — the
    RMS normal-distance a collapse may pull the surface (the reference passes meshopt
    target_error=0.05, Tets.cpp:258 — error-bounded collapse may legitimately stop
    short of the target). Returns None if the loop stalls far from the target (every
    candidate would flip a face or break manifoldness)."""
    nv = positions.shape[0]
    pos = positions.copy()
    q, w = _vertex_quadrics(pos, tris)

    # Adjacency: vertex -> set of face ids; faces mutate in place, dead ones marked.
    faces = tris.copy()
    alive = np.ones(len(faces), bool)
    vfaces: list[set] = [set() for _ in range(nv)]
    for f, t in enumerate(faces):
        for v in t:
            vfaces[v].add(f)

    parent = np.arange(nv)  # union-find over collapsed vertices

    def find(v: int) -> int:
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    version = np.zeros(nv, np.int64)

    def push(heap, a, b, bias=0.0):
        a, b = find(a), find(b)
        if a == b:
            return
        v, cost = _optimal_point(q[a] + q[b], pos[a], pos[b])
        # cost/weight ~ squared RMS normal distance: bound the geometric error, not
        # the (harmless) tangential travel of the collapse point.
        if max(cost, 0.0) > max_err * max_err * max(w[a] + w[b], 1e-300):
            return
        heapq.heappush(heap, (cost + bias, version[a] + version[b], a, b, v))

    edges = np.unique(np.sort(np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), axis=1), axis=0)
    heap: list = []
    attempts: dict = {}
    for a, b in edges:
        push(heap, int(a), int(b))

    n_alive = int(alive.sum())
    stale_limit = 64 * len(edges) + 4096  # stall guard
    pops = 0
    while n_alive > target_tris and heap and pops < stale_limit:
        cost, ver, a, b, v = heapq.heappop(heap)
        pops += 1
        a, b = find(a), find(b)
        if a == b or version[a] + version[b] != ver:
            continue

        def retry():
            # A guard rejection is not final — collapses elsewhere can make this edge
            # valid again. Re-queue behind other work, a bounded number of times.
            n = attempts.get((a, b), 0)
            if n < 8:
                attempts[(a, b)] = n + 1
                push(heap, a, b, bias=(cost + 1e-12) * (1 + n))

        shared = vfaces[a] & vfaces[b]
        # Manifold guard: an interior edge borders exactly 2 faces; more shared faces
        # means the collapse would pinch the surface.
        if len(shared) > 2:
            retry()
            continue

        # Flip guard: every surviving face at a or b must keep its orientation when
        # its corner moves to v.
        flips = False
        for f in (vfaces[a] | vfaces[b]) - shared:
            if not alive[f]:
                continue
            t = faces[f]
            corners = [pos[find(x)] if find(x) not in (a, b) else v for x in t]
            old = [pos[find(x)] for x in t]
            n_new = np.cross(corners[1] - corners[0], corners[2] - corners[0])
            n_old = np.cross(old[1] - old[0], old[2] - old[0])
            if n_new @ n_old <= 1e-30:
                flips = True
                break
        if flips:
            retry()
            continue

        # Commit: b merges into a, a moves to v.
        pos[a] = v
        q[a] = q[a] + q[b]
        w[a] = w[a] + w[b]
        parent[b] = a
        for f in shared:
            if alive[f]:
                alive[f] = False
                n_alive -= 1
            for x in faces[f]:
                vfaces[find(x)].discard(f)
            # find(x) already maps b to a here, so the copy of f registered under b
            # escapes the loop above — drop it before the merge resurrects it.
            vfaces[b].discard(f)
        vfaces[a] |= vfaces[b]
        vfaces[b] = set()
        version[a] += 1
        version[b] += 1

        neighbors = set()
        for f in vfaces[a]:
            for x in faces[f]:
                r = find(x)
                if r != a:
                    neighbors.add(r)
        for nb in neighbors:
            push(heap, a, nb)

    # Error-bounded collapse may stop short of the target (reference contract); fall
    # back only when it barely reduced the mesh at all.
    if n_alive > max(int(0.9 * len(tris)), target_tris * 2) and n_alive > 8:
        return None

    out = np.array([[find(x) for x in faces[f]] for f in np.flatnonzero(alive)],
                   dtype=np.int64)
    keep = (out[:, 0] != out[:, 1]) & (out[:, 1] != out[:, 2]) & (out[:, 0] != out[:, 2])
    out = out[keep]
    if out.size == 0:
        return None
    used, remap = np.unique(out.reshape(-1), return_inverse=True)
    return pos[used], remap.reshape(-1, 3).astype(np.uint32)


def _cluster_decimate(
    positions: np.ndarray, tris: np.ndarray, target_tris: int
) -> tuple[np.ndarray, np.ndarray]:
    """Uniform-grid vertex clustering: cruder than quadric collapse but unconditionally
    robust — the backstop for inputs the collapse loop rejects."""
    lo = positions.min(axis=0)
    extent = (positions.max(axis=0) - lo).max()
    res = 8
    best = (positions.copy(), tris.astype(np.uint32))
    for _ in range(12):
        cell = extent / res
        keys = np.floor((positions - lo) / cell).astype(np.int64)
        key1d = (keys[:, 0] << 42) | (keys[:, 1] << 21) | keys[:, 2]
        uniq, inverse = np.unique(key1d, return_inverse=True)
        reps = np.zeros((uniq.size, 3))
        counts = np.bincount(inverse, minlength=uniq.size).astype(np.float64)
        for d in range(3):
            reps[:, d] = np.bincount(inverse, weights=positions[:, d], minlength=uniq.size)
        reps /= counts[:, None]
        new_tris = inverse[tris]
        keep = (
            (new_tris[:, 0] != new_tris[:, 1])
            & (new_tris[:, 1] != new_tris[:, 2])
            & (new_tris[:, 0] != new_tris[:, 2])
        )
        new_tris = new_tris[keep]
        best = (reps, new_tris.astype(np.uint32))
        if new_tris.shape[0] >= target_tris or res > 4096:
            break
        res *= 2
    reps, new_tris = best
    used, remap = np.unique(new_tris.reshape(-1), return_inverse=True)
    return reps[used], remap.reshape(-1, 3).astype(np.uint32)


def simplify_surface(
    positions: np.ndarray, tris: np.ndarray, ratio: float
) -> tuple[np.ndarray, np.ndarray]:
    """Reduce triangle count to roughly `ratio` of the input (ratio in (0, 1])."""
    positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    if ratio >= 1.0 or tris.shape[0] <= 8:
        return positions.copy(), tris.astype(np.uint32)
    extent = (positions.max(axis=0) - positions.min(axis=0)).max()
    if extent <= 0:
        return positions.copy(), tris.astype(np.uint32)

    target_tris = max(int(tris.shape[0] * ratio), 4)
    # 0.05 relative error bound, the reference's meshopt target_error (Tets.cpp:258).
    result = _quadric_collapse(positions, tris, target_tris, max_err=0.05 * extent)
    if result is not None:
        return result
    return _cluster_decimate(positions, tris, target_tris)
