"""Per-element selection state (reference: src/selection/SelectionBitset.{h,cpp} —
element bitsets written by the GPU selection passes, read by transforms/overlays).

Selection lives as bitsets over one mesh's vertices/edges/faces. The picking layer
produces element ids (render/picking.py); this stores them with the editor's set
semantics (replace/add/subtract/toggle), converts between element domains through the
triangle topology, and grows selections along edges."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _edges_of(tris: np.ndarray) -> np.ndarray:
    """Unique sorted (a, b) edge list of a triangle mesh, lexicographic order."""
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    return np.unique(np.sort(e, axis=1), axis=0)


@dataclass
class SelectionState:
    """Vertex/edge/face bitsets for one mesh."""

    n_vertices: int
    triangles: np.ndarray
    vertices: np.ndarray = field(default=None)
    edges: np.ndarray = field(default=None)      # parallel to edge_list
    faces: np.ndarray = field(default=None)
    edge_list: np.ndarray = field(default=None)  # (E, 2) sorted vertex pairs

    def __post_init__(self):
        self.triangles = np.asarray(self.triangles, np.int64).reshape(-1, 3)
        self.edge_list = _edges_of(self.triangles)
        if self.vertices is None:
            self.vertices = np.zeros(self.n_vertices, bool)
        if self.edges is None:
            self.edges = np.zeros(self.edge_list.shape[0], bool)
        if self.faces is None:
            self.faces = np.zeros(self.triangles.shape[0], bool)

    # -- set semantics (the editor's replace/add/subtract/toggle modes) --

    def apply(self, domain: str, ids, mode: str = "replace") -> None:
        bits = getattr(self, domain)
        ids = np.asarray(list(ids) if not isinstance(ids, np.ndarray) else ids,
                         np.int64)
        if mode == "replace":
            bits[:] = False
            bits[ids] = True
        elif mode == "add":
            bits[ids] = True
        elif mode == "subtract":
            bits[ids] = False
        elif mode == "toggle":
            bits[ids] = ~bits[ids]
        else:
            raise ValueError(f"unknown mode {mode!r}")

    def edge_id(self, a: int, b: int) -> int:
        """Index of edge (a, b) in the bitset; -1 if absent."""
        key = (min(a, b), max(a, b))
        idx = np.searchsorted(self.edge_list[:, 0] * (self.n_vertices + 1)
                              + self.edge_list[:, 1],
                              key[0] * (self.n_vertices + 1) + key[1])
        if idx < self.edge_list.shape[0] and tuple(self.edge_list[idx]) == key:
            return int(idx)
        return -1

    def clear(self) -> None:
        self.vertices[:] = False
        self.edges[:] = False
        self.faces[:] = False

    def invert(self, domain: str) -> None:
        bits = getattr(self, domain)
        np.logical_not(bits, out=bits)

    # -- domain conversions through the topology --

    def faces_to_vertices(self) -> np.ndarray:
        """Vertex ids covered by the selected faces."""
        return np.unique(self.triangles[self.faces])

    def vertices_to_faces(self) -> np.ndarray:
        """Face ids whose three vertices are all selected."""
        sel = self.vertices[self.triangles]
        return np.nonzero(sel.all(axis=1))[0]

    def vertices_to_edges(self) -> np.ndarray:
        """Edge ids with both endpoints selected."""
        sel = self.vertices[self.edge_list]
        return np.nonzero(sel.all(axis=1))[0]

    # -- topology ops --

    def grow_vertices(self, rings: int = 1) -> None:
        """Expand the vertex selection along edges (the editor's grow-selection)."""
        for _ in range(rings):
            sel = self.vertices
            touched = np.zeros_like(sel)
            a, b = self.edge_list[:, 0], self.edge_list[:, 1]
            touched[b[sel[a]]] = True
            touched[a[sel[b]]] = True
            self.vertices = sel | touched

    def shrink_vertices(self, rings: int = 1) -> None:
        """Deselect boundary vertices (those with an unselected edge neighbor)."""
        for _ in range(rings):
            sel = self.vertices
            boundary = np.zeros_like(sel)
            a, b = self.edge_list[:, 0], self.edge_list[:, 1]
            boundary[a[sel[a] & ~sel[b]]] = True
            boundary[b[sel[b] & ~sel[a]]] = True
            self.vertices = sel & ~boundary

    def counts(self) -> dict:
        return {"vertices": int(self.vertices.sum()), "edges": int(self.edges.sum()),
                "faces": int(self.faces.sum())}
