"""The device eigensolver's iterations against the fineness of the surface handed to the
Delaunay mesher. The mesher keeps the surface's triangles, so a surface much coarser than
the lattice gives flat boundary tets, and the engine's iteration count follows the triangle
size, not the dof count (ROADMAP Queue 2).

On the CPU, at a small lattice (bbox / 10): the scene's wooden block as the 12-triangle
cuboid and as a 4 x 4 grid per face, through the port's engine (a bound on its iterations,
the host path's modes) and through the reference's engine on JAX's CPU backend, which
shares the difficulty: it gives up on the cuboid and needs 52 iterations on the grid box.

On a card, at full size (solve_surface's lattice rule, bbox / 24, the scene's default
settings), with the host fallback switched off: a solve that does not converge shows as 0
modes after max_restarts iterations instead of minutes of host shift-invert. No JAX import:
    python -m pytest --noconftest -m cuda -rA tests/test_torch_surface_fineness.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from mesheditor_tpu_torch import SolverConfig, mesh2modes
from mesheditor_tpu_torch.materials import PLASTIC, WOOD
from mesheditor_tpu_torch.mesh import cdt, cuboid_surface, grid_box_surface, icosphere_surface
from mesheditor_tpu_torch.solve import lobpcg

HALF = np.array([0.08, 0.02, 0.05])
CFG = SolverConfig(num_modes=30, num_fem_modes=45, max_mode_freq=16_000.0, host_fallback_n=0)
# A surface about as fine as the lattice solves in 23-30 iterations (NVIDIA H100); the bound
# leaves room for another card's rounding, not for the coarse surfaces' 44-100.
FINE_MOST_ITERATIONS = 40


def _ball(level):
    pts, tris = icosphere_surface(level)
    return pts * 0.05, tris, PLASTIC


def _grid_block(k):
    pts, tris = grid_box_surface(k)
    return (pts - 0.5) * 2.0 * HALF, tris, WOOD


SURFACES = {
    "icosphere4": (lambda: _ball(4), True),
    "icosphere3": (lambda: _ball(3), False),
    "icosphere2": (lambda: _ball(2), False),
    "grid_box16": (lambda: _grid_block(16), True),
    "grid_box8": (lambda: _grid_block(8), True),
    "grid_box4": (lambda: _grid_block(4), False),
    "cuboid": (lambda: (*cuboid_surface(tuple(HALF)), WOOD), False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _small_box_mesh(surface):
    """The block as the cuboid or as grid_box_surface(4), meshed at bbox / 10."""
    pts, tris, _wood = _grid_block(4) if surface == "grid4" else SURFACES["cuboid"][0]()
    return pts, cdt.generate_tets_delaunay(pts, tris, lattice_h=float(2 * HALF.max()) / 10)


@pytest.mark.parametrize("surface, most_iterations", [("cuboid", 60), ("grid4", 20)])
def test_device_engine_on_coarse_and_fine_box_surfaces(surface, most_iterations):
    """The cuboid takes several times the iterations of the grid box (45 against 11 here;
    more as the lattice gets finer). Until that is repaired this holds what works at this
    size: the engine answers on its own, inside the iteration bound given here, with the
    host shift-invert path's modes at the engine's parity (1e-6)."""
    pts, mesh = _small_box_mesh(surface)
    cfg = SolverConfig(num_modes=30, num_fem_modes=45, host_fallback_n=0)
    counts = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
    got = mesh2modes(mesh, WOOD.properties, pts[:4], config=replace(cfg, small_n=0),
                     device="cpu")
    assert (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES) == (counts[0] + 1, counts[1])
    host = mesh2modes(mesh, WOOD.properties, pts[:4], config=cfg, device="cpu")
    assert got.modes.num_modes == host.modes.num_modes > 0
    n = 6 + host.modes.num_modes
    lam, host_lam = got.summary.eigenvalues[6:n], host.summary.eigenvalues[6:n]
    assert np.abs(lam / host_lam - 1).max() < 1e-6
    assert got.profile.restarts <= most_iterations


@pytest.mark.parametrize("surface, modes", [("cuboid", 0), ("grid4", 10)])
def test_reference_engine_on_the_same_box_meshes(surface, modes):
    """What the port's counts can be held against: the reference's own engine (small_n=0,
    no host fallback, JAX on the CPU) gives up on the cuboid after 16 iterations with no
    modes, and takes 52 iterations for the grid box's 10 modes, where the port's engine
    takes 45 and 11. The coarse surface is hard for the algorithm both packages share."""
    import mesheditor_tpu  # noqa: F401  (enables x64)
    from mesheditor_tpu.materials import WOOD as REF_WOOD
    from mesheditor_tpu.solve.mesh2modes import mesh2modes as ref_mesh2modes
    from mesheditor_tpu.types import SolverConfig as RefSolverConfig

    pts, mesh = _small_box_mesh(surface)
    cfg = RefSolverConfig(num_modes=30, num_fem_modes=45, small_n=0, host_fallback_n=0)
    res = ref_mesh2modes(mesh, REF_WOOD.properties, pts[:4], config=cfg)
    print(f"reference engine, {surface}: {res.profile.dofs} dofs, {res.profile.restarts} "
          f"iterations, {res.modes.num_modes} modes")
    assert res.modes.num_modes == modes
    assert res.profile.restarts < cfg.max_restarts


@pytest.mark.cuda
@pytest.mark.parametrize("name", SURFACES)
def test_engine_iterations_follow_the_surface_fineness(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    make, fine = SURFACES[name]
    pts, tris, material = make()
    h = float((pts.max(axis=0) - pts.min(axis=0)).max()) / 24
    mesh = cdt.generate_tets_delaunay(pts, tris, lattice_h=h)
    counts = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
    res = mesh2modes(mesh, material.properties, pts[:4], config=CFG, device="cuda")
    print(f"{name}: {pts.shape[0]} surface points, {mesh.points.shape[0]} mesh points, "
          f"{res.profile.dofs} dofs, {res.profile.restarts} iterations, "
          f"{res.modes.num_modes} modes ({torch.cuda.get_device_name(0)})")
    # The counters name the path that answered: the engine, or (given up, no fallback) none.
    answered = int(res.modes.num_modes > 0)
    assert (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES) == (counts[0] + answered, counts[1])
    assert res.profile.restarts <= CFG.max_restarts
    if fine:
        assert res.modes.num_modes > 0
        assert res.profile.restarts <= FINE_MOST_ITERATIONS
    else:
        # A coarse surface either converges late or is given up at the limit with no modes
        # (never a part of the spectrum); with the repair these move into the fine cases.
        assert res.modes.num_modes > 0 or res.profile.restarts == CFG.max_restarts
