"""Minimal Wavefront OBJ triangle-mesh IO (positions + faces; fans triangulate n-gons).

Covers the reference's solve-input path (LoadObj in tests, tinyobj in the app) for the
RealImpact `transformed.obj` scans and general mesh import.
"""

from __future__ import annotations

import numpy as np


def load_obj(path) -> tuple[np.ndarray, np.ndarray]:
    """Returns (positions (n,3) float64, triangle indices (m,3) uint32)."""
    positions: list[list[float]] = []
    tris: list[tuple[int, int, int]] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for token in line.split()[1:]:
                    s = token.split("/")[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(positions) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1]))
    return (
        np.asarray(positions, dtype=np.float64).reshape(-1, 3),
        np.asarray(tris, dtype=np.uint32).reshape(-1, 3),
    )


def save_obj(path, positions: np.ndarray, tris: np.ndarray) -> None:
    positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    with open(path, "w") as f:
        for p in positions:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
