"""The tet mesher's structural snapshot (counterpart of scripts/tet_corpus_snapshot.py):
per case, the kept tets, points, lattice and thin-wall seeds, recovery Steiner points,
refinement points, carved and sliver counts, and a hash of the tets and the points, which
catch a mesh that is valid but different (reference: ModalSolverBench --snapshot against
tests/fixtures/TetCorpusSnapshot.txt).

The rows come from the port's own mesher build (mesheditor_tpu_torch/_build.py, built from
native/tetmesher.cpp at first use) and are held to tests/fixtures/tet_corpus_snapshot.txt.
Host work only: no device.

Usage: python -m mesheditor_tpu_torch.scripts.tet_corpus_snapshot > snapshot.txt
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..mesh import (bowl_surface, cone_surface, cuboid_surface, cylinder_surface,
                    icosphere_surface, shell_surface, torus_surface, uv_sphere_surface)
from ..mesh.cdt import TetProfile, generate_tets_delaunay
from ..mesh.isosurface import gyroid_shell_surface, noise_blob_surface


def corpus():
    """(name, (points, triangles)) for every snapshot case, in the fixture's order."""
    yield "icosphere2", icosphere_surface(2)
    yield "icosphere1_noisy", icosphere_surface(1, noise=0.02, seed=3)
    yield "cuboid", cuboid_surface((0.5, 0.3, 0.4))
    yield "torus", torus_surface(0.5, 0.2, 24, 12)
    yield "uv_sphere", uv_sphere_surface(0.5, 12, 24)
    yield "cone", cone_surface(0.5, 1.0, 24)
    # Thin shells of the scanned class (RealImpact bowls, plates and skillets: walls at
    # 2-5% of the diameter, where lattice seeding alone would starve the wall).
    yield "bowl5pct", bowl_surface(0.06, 0.003, 12, 40)
    yield "bowl2.5pct", bowl_surface(0.06, 0.0015, 12, 40)
    yield "bowl_scan_noisy", bowl_surface(0.06, 0.003, 12, 40, noise=0.15, seed=7)
    yield "sphere_shell4pct", shell_surface(*_scaled_icosphere(0.05), 0.002)
    yield "ellipsoid_shell", shell_surface(
        *_scaled_icosphere(np.array([0.06, 0.04, 0.02])), 0.0015)
    yield "plate_thin", cylinder_surface(0.09, 0.004, 48)
    # Iso-surfaces (marching tetrahedra): irregular triangulations with variable sizes and
    # aspects, saddles, several components and high genus.
    yield "iso_blob", noise_blob_surface(3, 22)
    yield "iso_blob_rough", noise_blob_surface(5, 22, roughness=0.04)
    yield "iso_gyroid", gyroid_shell_surface(20)
    # Triangle soup, cleaned by mesh/cdt.clean_surface_soup before meshing.
    yield from adversarial_corpus()


def adversarial_corpus():
    """Soup the mesher must survive: self-intersections, duplicate and degenerate faces,
    interior fins. An open surface is the documented reject."""
    p1, t1 = icosphere_surface(2)
    p1 = p1 * 0.05
    pts = np.vstack([p1, p1 + np.array([0.04, 0.0, 0.0])])
    tris = np.vstack([t1, t1 + p1.shape[0]])
    yield "adv_overlap_spheres", (pts, tris)
    pc, tc = cuboid_surface((0.1, 0.1, 0.1))
    tdeg = np.array([[0, 1, 1], [2, 2, 3]], np.uint32)
    pf = np.vstack([pc, pc[:2] + np.array([0.0, 0.0, 0.02])])
    fin = np.array([[0, 1, pc.shape[0]], [1, pc.shape[0] + 1, pc.shape[0]]], np.uint32)
    yield "adv_soup_combo", (pf, np.vstack([tc, tc[:4], tdeg, fin]))
    rng = np.random.default_rng(11)
    ps, ts = icosphere_surface(3)
    ps = ps * 0.05 * (1.0 + 0.25 * rng.standard_normal((ps.shape[0], 1)))
    yield "adv_spiky_scan", (ps, ts)  # sliver-rich self-intersecting scan-like blob


def _scaled_icosphere(scale):
    pts, tris = icosphere_surface(2)
    return pts * scale, tris


def snapshot_lines(include=None):
    """The snapshot's rows; `include`, a predicate on the case name, selects cases."""
    for name, (pos, tris) in corpus():
        if include is not None and not include(name):
            continue
        # Soup and iso-surface rows mesh without quality refinement: refining a
        # self-intersecting or wrinkly surface inserts ~1e5 Steiner points (minutes a row)
        # and pins nothing those rows are for (cleanup, survival, the recovery counters).
        quals = ((0.0, "noq"),) if name.startswith(("adv_", "iso_")) else (
            (0.0, "noq"), (2.0, "q2"))
        for q, tag in quals:
            prof = TetProfile()
            tm = generate_tets_delaunay(pos, tris, quality_bound=q, profile=prof)
            h = hashlib.sha256()
            h.update(np.ascontiguousarray(tm.tets).tobytes())
            h.update(np.ascontiguousarray(np.round(tm.points, 12)).tobytes())
            yield (f"{name}@{tag}: tets={prof.tets_kept} pts={tm.points.shape[0]} "
                   f"lattice={prof.lattice_points} thin={prof.thin_wall_seeds} "
                   f"steiner={prof.recovery_steiner} refine={prof.refine_points} "
                   f"rounds={prof.recovery_rounds} passes={prof.refine_passes} "
                   f"carved={prof.carved_out} slivers={prof.slivers_dropped} "
                   f"repaired={prof.sliver_repairs} hash={h.hexdigest()[:16]}")


def main():
    for line in snapshot_lines():
        print(line, flush=True)


if __name__ == "__main__":
    main()
