"""Half-edge triangle mesh: typed handles and topology iteration, array-backed.

The reference's Mesh is a half-edge structure with typed handles VH/EH/FH/HH and
topology iterators feeding selection, normals, and solve-input triangulation
(src/mesh/Mesh.h:13-120). This version keeps the connectivity array-first: it
lives in flat numpy arrays (vectorized construction via sort/unique), handles are ints,
and queries return arrays — no pointer-chasing object graph.

Half-edge h belongs to face h // 3, with next = 3*(h//3) + (h+1)%3. `twin[h]` is the
opposite half-edge or -1 on a boundary.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class HalfEdgeMesh:
    positions: np.ndarray  # (V, 3) float64
    triangles: np.ndarray  # (F, 3) int64
    dest: np.ndarray  # (H,) vertex each half-edge points to
    twin: np.ndarray  # (H,) opposite half-edge, -1 at boundaries
    vertex_halfedge: np.ndarray  # (V,) one outgoing half-edge per vertex (-1 isolated)

    # -- handle algebra --

    @staticmethod
    def face_of(h: int) -> int:
        return h // 3

    @staticmethod
    def next_of(h: int) -> int:
        return 3 * (h // 3) + (h + 1) % 3

    @staticmethod
    def prev_of(h: int) -> int:
        return 3 * (h // 3) + (h + 2) % 3

    def origin(self, h: int) -> int:
        return int(self.dest[self.prev_of(h)])

    # -- queries --

    def vertex_neighbors(self, v: int) -> np.ndarray:
        """One-ring vertex ids around v (unordered, unique)."""
        h = np.arange(len(self.dest))
        origins = self.dest[h // 3 * 3 + (h + 2) % 3]  # origin of each half-edge
        ring = np.unique(
            np.concatenate([self.dest[origins == v], origins[self.dest == v]])
        )
        return ring[ring != v]

    def vertex_faces(self, v: int) -> np.ndarray:
        """Faces incident to v."""
        return np.unique(np.flatnonzero((self.triangles == v).any(axis=1)))

    def face_neighbors(self, f: int) -> np.ndarray:
        """Faces sharing an edge with f."""
        hs = [3 * f, 3 * f + 1, 3 * f + 2]
        tw = self.twin[hs]
        return np.unique(tw[tw >= 0] // 3)

    def boundary_halfedges(self) -> np.ndarray:
        return np.flatnonzero(self.twin < 0)

    def is_closed(self) -> bool:
        return bool((self.twin >= 0).all())

    def edges(self) -> np.ndarray:
        """(E, 2) unique undirected edges."""
        a = self.dest[np.arange(len(self.dest)) // 3 * 3 + (np.arange(len(self.dest)) + 2) % 3]
        b = self.dest
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        return np.unique(np.stack([lo, hi], axis=1), axis=0)

    def vertex_normals(self) -> np.ndarray:
        n = np.zeros_like(self.positions)
        v = self.positions[self.triangles]
        fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        for k in range(3):
            np.add.at(n, self.triangles[:, k], fn)
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)

    def face_normals(self) -> np.ndarray:
        v = self.positions[self.triangles]
        fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        return fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-30)

    def triangle_indices(self) -> np.ndarray:
        """Flat triangulation indices (the solve-input path's CreateTriangleIndices)."""
        return self.triangles.reshape(-1).astype(np.uint32)


def build_halfedge(positions: np.ndarray, triangles: np.ndarray) -> HalfEdgeMesh:
    positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    f = tris.shape[0]
    h = 3 * f
    dest = np.empty(h, dtype=np.int64)
    # half-edge 3f+k goes corner k -> corner (k+1)%3
    dest[0::3] = tris[:, 1]
    dest[1::3] = tris[:, 2]
    dest[2::3] = tris[:, 0]
    origin = np.empty(h, dtype=np.int64)
    origin[0::3] = tris[:, 0]
    origin[1::3] = tris[:, 1]
    origin[2::3] = tris[:, 2]
    # Twin matching: sort directed edges by (min, max); pairs with opposite direction twin.
    lo = np.minimum(origin, dest)
    hi = np.maximum(origin, dest)
    key = lo * (positions.shape[0] + 1) + hi
    order = np.argsort(key, kind="stable")
    twin = np.full(h, -1, dtype=np.int64)
    ks = key[order]
    i = 0
    while i < h - 1:
        if ks[i] == ks[i + 1]:
            a, b = order[i], order[i + 1]
            if origin[a] != origin[b]:  # opposite orientation -> manifold pair
                twin[a] = b
                twin[b] = a
            i += 2
        else:
            i += 1
    vertex_halfedge = np.full(positions.shape[0], -1, dtype=np.int64)
    vertex_halfedge[origin[::-1]] = np.arange(h - 1, -1, -1)
    return HalfEdgeMesh(positions, tris, dest, twin, vertex_halfedge)
