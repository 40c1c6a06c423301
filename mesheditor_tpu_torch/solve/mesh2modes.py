"""The modal solve pipeline: tet mesh + material + excitation positions -> modal model
(counterpart of mesheditor_tpu/solve/mesh2modes.py).

Pipeline (mirrors modal::mesh2modes, src/audio/mesh2modes.cpp:605-658):
  1. filter degenerate tets (host, vectorized)
  2. lumped mass properties (host, vectorized)
  3. quadratic 10-node mesh build — sort-unique edge dedup (host, vectorized)
  4. element-matrix assembly (host numpy blocks, uploaded; float64 on the device)
  5. excitation positions -> nearest tet point, deduplicated
  6. generalized eigensolve (device: AMG-preconditioned float64 LOBPCG; host shift-invert
     for small pencils)
  7. postprocess to freqs/T60s/shapes

Tet geometry is in SI meters, so frequencies are in Hz and eigenvectors (hence shapes) are
mass-normalized (kg^-1/2).
"""

from __future__ import annotations

import os
import sys
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device, synchronize
from ..fem.assembly import assemble_element_matrices, filter_degenerate, pencil_diagonals
from ..fem.mass_properties import compute_mass_properties
from ..fem.quad_mesh import build_quad_mesh
from ..profile import scope
from ..types import (
    AcousticMaterialProperties,
    MassProperties,
    ModalModes,
    SolverConfig,
    SolveProfile,
    TetMesh,
)
from .lobpcg import lobpcg_pencil
from .postprocess import ModalEigenSummary, postprocess_modes


@dataclass
class SolveReuse:
    """A prior solve's eigenvector basis over the same tet inputs seeds the eigensolver,
    which re-converges it in a few iterations (warm_tolerance) instead of solving cold."""

    seed_basis: Optional[np.ndarray] = None  # (n_dofs, >=num_fem_modes)
    keep_basis: bool = False


@dataclass
class ModalResult:
    modes: ModalModes
    mass_props: MassProperties
    profile: SolveProfile
    summary: ModalEigenSummary
    basis: Optional[np.ndarray] = None  # full eigenvector basis (float32) when keep_basis
    # Index into modes.positions of each requested excitation position, in request order.
    sample_point_of_excitation: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint32)
    )


def _sample_excitations(points: np.ndarray, excite_positions: np.ndarray, inv_scale: np.ndarray):
    """Nearest tet point per excitation position, deduplicated in request order."""
    ex = np.asarray(excite_positions, dtype=np.float64).reshape(-1, 3)
    if ex.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros((0, 3), np.float32), np.zeros(0, np.uint32)
    # (n_ex, n_pts) distances; chunk if huge.
    nearest = np.empty(ex.shape[0], dtype=np.int64)
    chunk = max(1, int(4e7) // max(points.shape[0], 1))
    for s in range(0, ex.shape[0], chunk):
        d = ((ex[s : s + chunk, None, :] - points[None, :, :]) ** 2).sum(axis=2)
        nearest[s : s + chunk] = np.argmin(d, axis=1)
    sample_points: list[int] = []
    seen: dict[int, int] = {}
    remap = np.empty(ex.shape[0], dtype=np.uint32)
    for i, v in enumerate(nearest):
        v = int(v)
        if v not in seen:
            seen[v] = len(sample_points)
            sample_points.append(v)
        remap[i] = seen[v]
    pts = np.asarray(sample_points, dtype=np.int64)
    local = (points[pts] * inv_scale).astype(np.float32)
    return pts, local, remap


def mesh2modes(
    tets: TetMesh,
    material: AcousticMaterialProperties,
    excite_positions: np.ndarray,
    baked_scale=(1.0, 1.0, 1.0),
    config: SolverConfig = SolverConfig(),
    reuse: SolveReuse = SolveReuse(),
    cancelled: Optional[Callable[[], bool]] = None,
    progress: Optional[Callable[[float], None]] = None,
    mesh=None,
    verbose: Optional[bool] = None,
    device=None,
) -> ModalResult:
    """FEM modal analysis over quadratic (10-node) tetrahedral elements on `device` (the
    card when neither `device` nor `mesh` names one).

    `cancelled` (optional) is polled between stages and eigensolver iterations; a cancelled
    solve returns an empty result (the reference's JobMonitor contract, mesh2modes.h:75-77).
    `verbose` (default: the MESHEDITOR_TPU_VERBOSE env var) prints the per-stage wall-time
    report on completion.

    `mesh` (optional, parallel.make_mesh, with a "tp" axis) runs the same solve with the
    elements sharded over the rank's tp group, on the mesh's device: every rank of the
    group calls this with the same arguments, applies its slice of the elements and sums
    the partials by all_reduce (the reference's reduction points,
    src/audio/mesh2modes.cpp:379-398), and every rank returns the same eigenvalues.

    The call is the `solve/mesh2modes` span (profile.py), which waits for the device
    under `profile.enabled`; its stages are `solve/assemble`, `solve/amg` and
    `solve/eigs`, on the boundaries of their SolveProfile fields.
    """
    if mesh is not None:
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device!r} is not the mesh's device {mesh.device}")
        device = mesh.device
    device = resolve_device("cuda" if device is None else device)
    with scope("solve/mesh2modes", sync=device):
        return _mesh2modes(tets, material, excite_positions, baked_scale, config, reuse,
                           cancelled, progress, mesh, verbose, device)


def _mesh2modes(tets, material, excite_positions, baked_scale, config, reuse, cancelled,
                progress, mesh, verbose, device) -> ModalResult:
    """mesh2modes on its resolved device."""
    if verbose is None:
        verbose = bool(os.environ.get("MESHEDITOR_TPU_VERBOSE"))
    profile = SolveProfile()
    config = config.clamp()
    baked_scale = np.asarray(baked_scale, dtype=np.float64).reshape(3)
    length_to_si = float(baked_scale.sum() / 3.0)

    kept = filter_degenerate(tets.points, tets.tets)

    t0 = time.perf_counter()
    mass_props = compute_mass_properties(
        tets.points, kept, material.density, baked_scale, length_to_si
    )
    profile.mass_props = time.perf_counter() - t0
    if progress:
        progress(0.1)

    t0 = time.perf_counter()
    quad = build_quad_mesh(kept, tets.points.shape[0])
    profile.quad_mesh = time.perf_counter() - t0

    with scope("solve/assemble"):
        t0 = time.perf_counter()
        ops = assemble_element_matrices(tets.points, kept, material, quad, device=device)
        if mesh is not None:
            from ..parallel.sharding import shard_element_ops

            ops = shard_element_ops(ops, mesh)
        synchronize(device)
        profile.assemble = time.perf_counter() - t0
    profile.dofs = ops.n_dofs
    profile.stiffness_nonzeros = int(kept.shape[0]) * 30 * 30  # element-form storage
    if cancelled and cancelled():
        return ModalResult(_empty_modes(), mass_props, profile, ModalEigenSummary())

    t0 = time.perf_counter()
    ex_points, positions, remap = _sample_excitations(
        tets.points, excite_positions, 1.0 / baked_scale
    )
    profile.sample_excite = time.perf_counter() - t0

    n = ops.n_dofs
    fem_n_modes = min(config.num_fem_modes, n - 1)
    sigma = -((2 * np.pi * config.min_mode_freq) ** 2)
    if progress:
        progress(0.3)

    with scope("solve/amg"):
        t0 = time.perf_counter()
        k_diag, m_diag = pencil_diagonals(ops)
        # Preconditioner setup = the reference's Factorize stage: the rigid-body
        # aggregation AMG replaces the sparse Cholesky factorization.
        precond = None
        if config.use_amg and n > config.small_n:
            from .amg import build_amg

            try:
                precond = build_amg(tets.points, kept, quad, ops, k_diag, m_diag, sigma)
            except (torch.linalg.LinAlgError, np.linalg.LinAlgError) as ex:
                # lobpcg_pencil then answers on the host (counted in HOST_SOLVES).
                warnings.warn(f"AMG build failed ({ex}); the eigensolve falls back to the host")
            if ops.tp is not None and ops.tp.any(precond is None):
                precond = None  # the group takes the host path together
        synchronize(device)
        profile.factorize = time.perf_counter() - t0

    x0 = None
    tol = config.tolerance
    if (reuse.seed_basis is not None and reuse.seed_basis.shape[0] == n
            and reuse.seed_basis.shape[1] >= fem_n_modes):
        x0 = np.asarray(reuse.seed_basis, dtype=np.float64)
        tol = config.warm_tolerance

    def callback(iteration, settled):
        if progress:
            progress(0.3 + 0.65 * min(settled / max(fem_n_modes, 1), 1.0))
        return bool(cancelled and cancelled())

    with scope("solve/eigs"):
        t0 = time.perf_counter()
        eig = lobpcg_pencil(
            ops,
            fem_n_modes,
            sigma=sigma,
            precond=precond,
            x0=x0,
            guard=config.guard,
            tol=tol,
            max_iters=config.max_restarts,
            inner_iters=config.inner_iters,
            callback=callback,
            small_n=config.small_n,
            host_fallback_n=config.host_fallback_n,
            tol_accept=config.tol_accept,
        )
        synchronize(device)
        profile.iterate = time.perf_counter() - t0
    profile.op_applications = eig.op_applications
    profile.restarts = eig.iterations
    if eig.eigenvalues.size == 0:
        if verbose:
            print(f"[mesh2modes] {profile.report()} (no modes)", file=sys.stderr, flush=True)
        return ModalResult(_empty_modes(), mass_props, profile, ModalEigenSummary(), None, remap)

    t0 = time.perf_counter()
    # Eigenvectors are M-orthonormal, so shapes are already mass-normalized (kg^-1/2).
    # Only the excitation rows leave the device.
    ev = eig.eigenvectors  # (n, fem_n_modes)
    dof_rows = torch.as_tensor((3 * ex_points[:, None] + np.arange(3)[None, :]).reshape(-1),
                               device=ev.device)
    shapes = ev.index_select(0, dof_rows).to(torch.float32).cpu().numpy()
    shapes = shapes.reshape(ex_points.shape[0], 3, fem_n_modes)
    shapes = np.ascontiguousarray(np.transpose(shapes, (0, 2, 1)))  # (points, modes, 3)
    profile.extract = time.perf_counter() - t0

    summary = ModalEigenSummary(
        eigenvalues=eig.eigenvalues.copy(), shapes=shapes, solved_material=material
    )
    modes = postprocess_modes(eig.eigenvalues, shapes, 1.0, material, config, positions)
    modes.baked_scale = baked_scale.astype(np.float32)
    basis = ev.to(torch.float32).cpu().numpy() if reuse.keep_basis else None
    if verbose:
        print(f"[mesh2modes] {profile.report()}", file=sys.stderr, flush=True)
    return ModalResult(modes, mass_props, profile, summary, basis, remap)


def _empty_modes() -> ModalModes:
    return ModalModes(np.zeros(0), np.zeros(0), np.zeros((0, 0, 3), np.float32))
