"""Thin shells, the scanned-object regime, through the port: a 5%-wall bowl and a 4 mm plate
through the port's Delaunay mesher build, its assembly and its eigensolve on the CPU, as
tests/test_thin_shell_parity.py takes them through the JAX package.

The reference's corpus is thin-walled scans (RealImpact bowls and plates at 2-5% wall; the
reference's tests/ModalSolverTest.cpp:316-349). Each surface's mesh equals the JAX
package's mesh of it (the same tets and points), the port's frequencies are within 0.1% of
scipy's shift-invert on the same pencil (BASELINE.md's parity bar), and the path that
answered (the device engine or the host shift-invert) and the engine's iterations are held
to what this CPU gives. The 2.5%-wall bowl, the noisy scanned bowl and the ellipsoid shell
are slow, as in the JAX file.
"""

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch import SolverConfig, mesh2modes
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import (bowl_surface, cylinder_surface, icosphere_surface,
                                       shell_surface)
from mesheditor_tpu_torch.mesh.cdt import TetProfile, generate_tets_delaunay
from mesheditor_tpu_torch.solve import lobpcg

from chip_smoke import host_oracle

SIGMA = -((2 * np.pi * 20.0) ** 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _connected_components(tets: np.ndarray) -> int:
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    t = np.asarray(tets, np.int64)
    n = int(t.max()) + 1
    g = sp.coo_matrix((np.ones(3 * t.shape[0], np.int8),
                       (t[:, :-1].reshape(-1), t[:, 1:].reshape(-1))), shape=(n, n))
    used = np.zeros(n, bool)
    used[t.reshape(-1)] = True
    _, labels = connected_components(g, directed=False)
    return np.unique(labels[used]).size


def _mesh_both(pos, tris):
    """The port's mesh of a surface, held to the JAX package's: the same tets and points."""
    from mesheditor_tpu.mesh.cdt import generate_tets_delaunay as jax_generate_tets

    prof = TetProfile()
    tm = generate_tets_delaunay(pos, tris, profile=prof)
    ref = jax_generate_tets(pos, tris)
    assert tm.tets.shape[0] > 0, "mesher produced an empty tet set"
    assert np.array_equal(tm.tets, ref.tets)
    assert np.array_equal(tm.points, ref.points)
    assert _connected_components(tm.tets) == 1, "sliver handling perforated the domain"
    return tm, prof


def _solve(tm, nev):
    """The port's solve on the CPU at the JAX test's settings, against scipy. Returns (max
    relative frequency error, dofs, path, iterations)."""
    cfg = SolverConfig(num_modes=nev, num_fem_modes=nev + 6, max_mode_freq=96_000.0)
    excite = tm.points[:: max(tm.points.shape[0] // 4, 1)][:4]
    before = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
    result = mesh2modes(tm, CERAMIC.properties, excite, config=cfg, device="cpu")
    path = ("device" if lobpcg.DEVICE_SOLVES > before[0] else
            "host" if lobpcg.HOST_SOLVES > before[1] else "none")
    assert result.modes.num_modes > 0, "solver returned an empty modal model"
    f_true = np.sqrt(np.maximum(host_oracle(tm, nev + 10, SIGMA, CERAMIC.properties), 0))
    f_true = f_true[f_true > 2 * np.pi * 20.0] / (2 * np.pi)  # the audible band
    got = np.asarray(result.modes.freqs)
    k = min(got.size, f_true.size, nev - 6)
    rel = np.abs(got[:k] - f_true[:k]) / f_true[:k]
    return float(rel.max()), result.profile.dofs, path, result.profile.restarts


def test_bowl_5pct_wall():
    """The 5%-wall hemispherical bowl: thin-wall seeding fires, the domain stays whole, the
    device engine answers (24,510 dofs, over small_n) within 0.1% of scipy."""
    tm, prof = _mesh_both(*bowl_surface(0.06, 0.003, 8, 24))
    assert prof.thin_wall_seeds > 0, "interval seeding should fire on thin walls"
    rel, dofs, path, iterations = _solve(tm, 14)
    assert rel < 1e-3
    assert (dofs, path) == (24_510, "device")
    assert iterations == 38


def test_thin_plate():
    """The 4 mm plate (a cylinder at 4.4% of its diameter), the flat-shell case: 4,410 dofs,
    under small_n, so the host shift-invert answers."""
    tm, _ = _mesh_both(*cylinder_surface(0.09, 0.004, 32))
    rel, dofs, path, iterations = _solve(tm, 12)
    assert rel < 1e-3
    assert (dofs, path, iterations) == (4_410, "host", 1)


def test_open_surface_raises():
    """An open surface (a patch deleted) is rejected with a ValueError by both packages,
    never meshed (reference: Tetrahedralize.h:44-60 requires a closed surface)."""
    from mesheditor_tpu.mesh.cdt import generate_tets_delaunay as jax_generate_tets

    pos, tris = bowl_surface(0.06, 0.003, 8, 24)
    open_tris = tris[: tris.shape[0] - 30]
    with pytest.raises(ValueError):
        generate_tets_delaunay(pos, open_tris)
    with pytest.raises(ValueError):
        jax_generate_tets(pos, open_tris)


def _ellipsoid_shell():
    pts, tris = icosphere_surface(2)
    return shell_surface(pts * np.array([0.06, 0.04, 0.02]), tris, 0.0015)


@pytest.mark.slow
@pytest.mark.parametrize("name,surface,nev", [
    ("bowl_2_5pct_wall", lambda: bowl_surface(0.06, 0.0015, 12, 40), 16),
    ("noisy_scanned_bowl", lambda: bowl_surface(0.06, 0.003, 12, 40, noise=0.15, seed=7), 12),
    ("ellipsoid_shell", _ellipsoid_shell, 12),
])
def test_thin_shell_full(name, surface, nev):
    tm, _ = _mesh_both(*surface())
    rel, dofs, path, iterations = _solve(tm, nev)
    print(f"{name}: {dofs} dofs, answered by {path}, {iterations} iterations, rel {rel:.2e}")
    assert rel < 1e-3
