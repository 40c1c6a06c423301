"""Quadratic (10-node) mesh construction: unique mid-edge node ids per tet edge.

The reference builds this with a hash map (src/audio/mesh2modes.cpp:246-264); here the
edge dedup is fully vectorized with a sort-based unique over packed 64-bit edge keys, so
it scales to corpus-sized meshes without a Python loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .quad_basis import EDGE_CORNERS


@dataclass
class QuadMesh:
    """Global node ids of each element's 10 nodes: the 4 corners, then unique mid-edge ids
    numbered after all corner nodes. Mid-edge coordinates stay implicit (straight-sided)."""

    element_nodes: np.ndarray  # (m, 10) int32
    node_count: int


def build_quad_mesh(tets: np.ndarray, num_points: int) -> QuadMesh:
    tets = np.asarray(tets, dtype=np.int64)
    m = tets.shape[0]
    ec = np.asarray(EDGE_CORNERS, dtype=np.int64)  # (6, 2)
    a = tets[:, ec[:, 0]]  # (m, 6)
    b = tets[:, ec[:, 1]]
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    keys = (lo << np.int64(32)) | hi  # (m, 6)
    unique_keys, inverse = np.unique(keys.reshape(-1), return_inverse=True)
    element_nodes = np.empty((m, 10), dtype=np.int32)
    element_nodes[:, :4] = tets
    element_nodes[:, 4:] = (num_points + inverse.reshape(m, 6)).astype(np.int32)
    return QuadMesh(element_nodes, int(num_points + unique_keys.size))
