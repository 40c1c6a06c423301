"""ctypes binding for the native Delaunay tet mesher (native/tetmesher.cpp).

`generate_tets_delaunay` preserves the input surface vertices exactly in the output
(vertex i of the surface is vertex i of the tet mesh) and fills the interior with a
lattice — significantly closer to the reference's CDT behavior than the voxel mesher.
The library is compiled from the source at first use (`_build.load_tetmesher`); a build or
load that fails raises RuntimeError or OSError, never the ValueError that reports a surface
the mesher could not mesh, so a caller can fall back to `voxel_tets.generate_tets` for the
second and only the second.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from .._build import load_tetmesher
from ..types import TetMesh

NATIVE_MESHES = 0  # meshes the native mesher answered (mesh/voxel_tets.py counts its own)


@dataclass
class TetProfile:
    """Per-stage mesher counters (reference: tetra::Profile, Tetrahedralize.h:29-42 —
    flip/split/Steiner/missing-face counters surfaced by the corpus snapshot).
    Deterministic, so snapshot tests can compare counts across runs/machines."""

    lattice_points: int = 0
    recovery_steiner: int = 0
    refine_points: int = 0
    recovery_rounds: int = 0
    refine_passes: int = 0
    carved_out: int = 0
    slivers_dropped: int = 0
    tets_kept: int = 0
    thin_wall_seeds: int = 0  # mid-thickness interval seeds (thin-shell starvation fix)
    sliver_repairs: int = 0  # circumcenter/midpoint insertions that excavated slivers


def _edge_counts(tt: np.ndarray):
    """Occurrence count of each undirected edge; returns (keys_per_tri (T,3), uniq, counts)."""
    a = np.minimum(tt, np.roll(tt, -1, axis=1)).astype(np.int64)
    b = np.maximum(tt, np.roll(tt, -1, axis=1)).astype(np.int64)
    keys = (a << np.int64(32)) | b
    uniq, counts = np.unique(keys.reshape(-1), return_counts=True)
    return keys, uniq, counts


def clean_surface_soup(tris: np.ndarray):
    """Tolerate reference-grade triangle soup (Tetrahedralize.h:44-60 accepts closed,
    possibly non-manifold input): returns (clean_tris, report dict).

    Three cleanup passes:
      1. drop DEGENERATE faces (repeated vertex);
      2. DEDUPE faces (same vertex set): accidental re-emissions collapse to one
         representative;
      3. iteratively PEEL faces carrying a DANGLING edge (edge count 1) — interior
         fins and flaps vanish layer by layer, a genuinely open surface peels down
         and is rejected by the watertight gate afterwards with an honest error.
    """
    tt = np.ascontiguousarray(tris, dtype=np.uint32).reshape(-1, 3)
    n0 = tt.shape[0]
    degen = (tt[:, 0] == tt[:, 1]) | (tt[:, 1] == tt[:, 2]) | (tt[:, 0] == tt[:, 2])
    tt = tt[~degen]
    # Dedupe on the unordered vertex-set key (first occurrence wins).
    sv = np.sort(tt.astype(np.int64), axis=1)
    key = (sv[:, 0] << np.int64(42)) | (sv[:, 1] << np.int64(21)) | sv[:, 2]
    _, first = np.unique(key, return_index=True)
    keep = np.zeros(tt.shape[0], bool)
    keep[first] = True
    n_dup = int(tt.shape[0] - keep.sum())
    tt = tt[keep]
    # Peel faces carrying dangling (count-1) edges until none remain.
    n_peeled = 0
    while tt.shape[0]:
        keys, uniq_e, counts_e = _edge_counts(tt)
        dangling = uniq_e[counts_e == 1]
        if dangling.size == 0:
            break
        bad = np.isin(keys, dangling).any(axis=1)
        if not bad.any():
            break
        n_peeled += int(bad.sum())
        tt = tt[~bad]
    report = {
        "degenerate": int(degen.sum()),
        "duplicates": n_dup,
        "peeled": n_peeled,
        "kept": int(tt.shape[0]),
        "input": n0,
    }
    return tt, report


def generate_tets_delaunay(
    positions: np.ndarray, tris: np.ndarray, lattice_h: float = 0.0,
    quality_bound: float = 0.0, profile: TetProfile | None = None
) -> TetMesh:
    """Tet-mesh the interior of a closed surface; surface vertex ids are preserved.
    `lattice_h` is the interior point spacing (0 picks bbox/16). `quality_bound` > 0
    enables Delaunay quality refinement to circumradius/shortest-edge <= bound (the
    reference's optional -q refinement, Tetrahedralize.h:18-21; 2.0 is its default).

    Accepts reference-grade soup: degenerate faces, duplicated faces, and dangling
    fins are cleaned off first (clean_surface_soup); what must remain is a closed
    (possibly self-intersecting, possibly non-manifold-vertex) surface."""
    global NATIVE_MESHES
    lib = load_tetmesher()
    pts = np.ascontiguousarray(positions, dtype=np.float64).reshape(-1, 3)
    tt, _soup = clean_surface_soup(tris)
    # Watertightness gate AFTER cleanup: the mesher's inside test (ray-crossing
    # parity) silently tolerates small holes, producing a plausible-looking but
    # wrong domain. The reference requires a closed surface as an input CONTRACT
    # (Tetrahedralize.h:44-60); enforce it with the standard manifold-edge count.
    if tt.shape[0] == 0:
        raise ValueError(
            f"surface is empty after soup cleanup ({_soup['degenerate']} degenerate, "
            f"{_soup['duplicates']} duplicated, {_soup['peeled']} peeled off open "
            f"edges of {_soup['input']} faces) — the input is not a closed surface"
        )
    _, _, counts = _edge_counts(tt)
    n_open = int((counts % 2 != 0).sum())
    if n_open:
        raise ValueError(
            f"surface is not watertight: {n_open} edges have an odd triangle count "
            f"(open boundary) after soup cleanup — close the surface before "
            f"tetrahedralization"
        )
    scale = ctypes.c_double(0.0)
    ntets = ctypes.c_uint64(0)
    npts = ctypes.c_uint64(0)
    prof = (ctypes.c_double * 10)()
    p_pts = pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    p_tris = tt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    rc = lib.tetmesh_delaunay(
        p_pts, pts.shape[0], p_tris, tt.shape[0], lattice_h, quality_bound,
        ctypes.byref(scale), None, ctypes.byref(ntets), None, ctypes.byref(npts), prof,
    )
    if rc != 0:
        raise ValueError(f"tetmesh_delaunay failed with code {rc}")
    if ntets.value == 0:
        raise ValueError("no interior tets (thin-walled or open surface?)")
    out_tets = np.empty((ntets.value, 4), dtype=np.uint32)
    out_pts = np.empty((npts.value, 3), dtype=np.float64)
    cap_t = ctypes.c_uint64(ntets.value)
    cap_p = ctypes.c_uint64(npts.value)
    rc = lib.tetmesh_delaunay(
        p_pts, pts.shape[0], p_tris, tt.shape[0], lattice_h, quality_bound,
        ctypes.byref(scale),
        out_tets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), ctypes.byref(cap_t),
        out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.byref(cap_p),
        prof,
    )
    if rc != 0:
        raise ValueError(f"tetmesh_delaunay (copy pass) failed with code {rc}")
    if profile is not None:
        (profile.lattice_points, profile.recovery_steiner, profile.refine_points,
         profile.recovery_rounds, profile.refine_passes, profile.carved_out,
         profile.slivers_dropped, profile.tets_kept, profile.thin_wall_seeds,
         profile.sliver_repairs) = (int(v) for v in prof)
    NATIVE_MESHES += 1
    return TetMesh(points=out_pts[: cap_p.value], tets=out_tets[: cap_t.value])
