"""Solve benchmark through the full meshing pipeline (counterpart of scripts/cdt_bench.py):
the headline bench uses a structured box, and the per-element conditioning of Delaunay tets
is what stresses the preconditioner.

Meshes an irregular scanned-class surface (a vertex-jittered icosphere) with the native
conforming-Delaunay tetrahedralizer, then times the warm modal solve. Prints one JSON line
with scripts/cdt_bench.py's keys, the card, and the path that answered the timed solve:
"device" (the float64 device engine) or "host" (the host shift-invert, which also takes
the solves the device engine gives up on, "host fallback" then; solve/lobpcg.py counts
both).

Usage: python -m mesheditor_tpu_torch.scripts.cdt_bench [--modes 256] [--subdiv 3]
       [--jitter 0.02] [--tolerance 1e-6] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .. import SolverConfig, mesh2modes
from .._device import card_label, resolve_device
from ..materials import CERAMIC
from ..mesh import icosphere_surface
from ..mesh.cdt import generate_tets_delaunay
from ..solve import lobpcg


def _path(device_solves: int, host_solves: int, dofs: int, cfg: SolverConfig) -> str:
    """Which path answered one solve: "device", "host" (a pencil at or below small_n dofs)
    or "host fallback" (the device engine gave up and the host answered)."""
    if (device_solves, host_solves) == (1, 0):
        return "device"
    if (device_solves, host_solves) == (0, 1):
        return "host" if dofs <= cfg.clamp().small_n else "host fallback"
    raise RuntimeError(f"one solve counted {device_solves} device and {host_solves} host "
                       "answers")


def cdt_case(modes=256, subdiv=3, jitter=0.02, tolerance=1e-6, lattice=14,
             device="cuda") -> dict:
    """The jittered icosphere (radius 5 cm, seed 7, `jitter` of the radius) meshed at
    bbox / lattice and solved to `modes`, a warm-up solve first. Returns the report."""
    device = resolve_device(device)
    radius = 0.05
    pts, tris = icosphere_surface(subdiv)
    pts = pts * radius
    rng = np.random.default_rng(7)
    pts = pts + rng.standard_normal(pts.shape) * (jitter * radius)

    t0 = time.perf_counter()
    bbox = pts.max(0) - pts.min(0)
    mesh = generate_tets_delaunay(pts, tris, lattice_h=float(bbox.max()) / lattice)
    mesh_s = time.perf_counter() - t0

    cfg = SolverConfig(num_modes=modes, num_fem_modes=modes, max_mode_freq=48_000.0,
                       tolerance=tolerance)
    excite = mesh.points[:: max(mesh.points.shape[0] // 10, 1)][:10]

    r = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, device=device)  # warm-up
    if r.modes.num_modes == 0:
        raise RuntimeError("CDT solve failed")
    solves = lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES
    t0 = time.perf_counter()
    r = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, device=device)
    solve_s = time.perf_counter() - t0
    device_solves = lobpcg.DEVICE_SOLVES - solves[0]
    host_solves = lobpcg.HOST_SOLVES - solves[1]
    return {
        "metric": "cdt_icosphere_solve",
        "tets": int(mesh.tets.shape[0]),
        "dofs": int(r.profile.dofs),
        "modes": int(r.modes.num_modes),
        "mesh_s": round(mesh_s, 3),
        "solve_s": round(solve_s, 3),
        "iters": int(r.profile.restarts),
        "factorize_s": round(r.profile.factorize, 3),
        "iterate_s": round(r.profile.iterate, 3),
        "f1_hz": float(r.modes.freqs[0]) if r.modes.num_modes else 0.0,
        "path": _path(device_solves, host_solves, r.profile.dofs, cfg),
        "card": card_label(device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", type=int, default=256)
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--jitter", type=float, default=0.02, help="vertex jitter, fraction of radius")
    ap.add_argument("--tolerance", type=float, default=1e-6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = cdt_case(args.modes, args.subdiv, args.jitter, args.tolerance, device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
