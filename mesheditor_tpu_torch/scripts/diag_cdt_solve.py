"""Where the solve of the reference bench's CDT case goes (counterpart of
scripts/diag_cdt_solve.py): the quickstart torus (0.06, 0.025) meshed by the Delaunay
mesher at bbox/24 (51,402 dofs) and solved by mesh2modes at the quickstart's settings (30
modes, 45 FEM modes, ceramic), `runs` times, with the eigensolver's per-iteration trace on
(MESHEDITOR_TPU_DEBUG_EIG, one `[ortho]` line an iteration) and the profile tree and the
stage report printed after each run. Runs after the first show the run-to-run spread.

Usage: python -m mesheditor_tpu_torch.scripts.diag_cdt_solve [runs=2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def diag(runs: int = 2, lattice: int = 24, device="cuda") -> list[dict]:
    """Mesh the torus at bbox / `lattice` and solve it `runs` times on `device`, the trace
    on unless MESHEDITOR_TPU_DEBUG_EIG is set already. Returns one dict a run: its wall,
    dofs, modes, f1 and iterations."""
    from .. import SolverConfig, mesh2modes, profile
    from .._device import card_label, resolve_device, synchronize
    from ..materials import CERAMIC
    from ..mesh import torus_surface
    from ..mesh.cdt import generate_tets_delaunay

    device = resolve_device(device)
    pts, tris = torus_surface(0.06, 0.025)
    h = float(np.max(pts.max(0) - pts.min(0))) / lattice
    t0 = time.perf_counter()
    tm = generate_tets_delaunay(pts, tris, lattice_h=h)
    print(f"mesh: {tm.tets.shape[0]} tets in {time.perf_counter() - t0:.1f}s; solving on "
          f"{card_label(device)}", flush=True)

    # The quickstart's solve settings (solve_surface defaults at num_modes=30).
    cfg = SolverConfig(num_modes=30, num_fem_modes=45)
    excite = tm.points[:: max(tm.points.shape[0] // 10, 1)][:10]

    env, enabled = os.environ.get("MESHEDITOR_TPU_DEBUG_EIG"), profile.enabled
    os.environ.setdefault("MESHEDITOR_TPU_DEBUG_EIG", "1")
    profile.enabled = True
    rows = []
    try:
        for i in range(runs):
            profile.reset()
            t0 = time.perf_counter()
            with profile.scope("mesh2modes", sync=device):
                r = mesh2modes(tm, CERAMIC.properties, excite, config=cfg, verbose=True,
                               device=device)
            synchronize(device)
            dt = time.perf_counter() - t0
            f1 = float(r.modes.freqs[0]) if r.modes.num_modes else 0.0
            rows.append({"wall_s": dt, "dofs": r.profile.dofs, "modes": r.modes.num_modes,
                         "f1_hz": f1, "iterations": r.profile.restarts})
            print(f"--- run {i}: {dt:.1f}s wall, modes={r.modes.num_modes}, f1={f1:.2f} Hz, "
                  f"dofs={r.profile.dofs}, iterations={r.profile.restarts}", flush=True)
            print(profile.report(min_share=0.02), flush=True)
            print(r.profile.report(), flush=True)
    finally:
        profile.enabled = enabled
        if env is None:
            os.environ.pop("MESHEDITOR_TPU_DEBUG_EIG", None)
    return rows


def main(argv=None, lattice: int = 24) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return diag(args.runs, lattice, args.device)


if __name__ == "__main__":
    main()
