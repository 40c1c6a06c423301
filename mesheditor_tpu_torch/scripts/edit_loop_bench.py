"""Edit-loop bench: cold solve vs warm-started re-solve vs exact material rescale
(counterpart of scripts/edit_loop_bench.py; reference: ModalSolverBench --edit-loop, the
interactive edit cycle the warm-start machinery exists for).

Three tiers of the same "user edits the material" loop:
  1. cold    - full solve from a random subspace, keeping its basis
  2. warm    - re-solve after a Poisson-ratio edit, seeded with that basis (SolveReuse)
  3. rescale - exact closed-form E/rho rescale, no solve at all (rescale_modes)

Usage: python -m mesheditor_tpu_torch.scripts.edit_loop_bench [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import SolverConfig, SolveReuse, mesh2modes
from .._device import card_label, resolve_device
from ..materials import CERAMIC
from ..mesh import box_tets
from ..solve.postprocess import rescale_modes
from ..types import AcousticMaterialProperties

E_SCALE, RHO_SCALE = 0.8, 1.3  # the rescaled edit: E x 0.8, rho x 1.3


def edit_loop(resolution=(12, 7, 6), n_modes=96, device="cuda", progress=print) -> dict:
    """The three tiers on the box at `resolution`, after a warm-up solve. Returns each
    tier's result and wall time, and the closed-form f1 of the rescale."""
    device = resolve_device(device)
    mesh = box_tets((0.3, 0.16, 0.15), resolution)
    cfg = SolverConfig(num_modes=n_modes, num_fem_modes=n_modes, max_mode_freq=48_000.0,
                       tolerance=1e-6)
    excite = mesh.points[:: max(mesh.points.shape[0] // 10, 1)][:10]
    mat = CERAMIC.properties

    def solve(material, reuse):  # mesh2modes waits for the device: walls end on the host
        return mesh2modes(mesh, material, excite, config=cfg, reuse=reuse, device=device)

    solve(mat, SolveReuse(keep_basis=True))  # warm-up

    t0 = time.perf_counter()
    cold = solve(mat, SolveReuse(keep_basis=True))
    cold_s = time.perf_counter() - t0
    if progress:
        progress(f"cold:    {cold_s:6.1f}s  iters={cold.profile.restarts} "
                 f"f1={float(cold.modes.freqs[0]):.2f}")

    # A material edit that CANNOT be rescaled exactly (Poisson changes mode shapes).
    mat_nu = AcousticMaterialProperties(mat.density, mat.young_modulus,
                                        mat.poisson_ratio + 0.02, mat.alpha, mat.beta)
    t0 = time.perf_counter()
    warm = solve(mat_nu, SolveReuse(seed_basis=cold.basis))
    warm_s = time.perf_counter() - t0
    if progress:
        progress(f"warm:    {warm_s:6.1f}s  iters={warm.profile.restarts} "
                 f"f1={float(warm.modes.freqs[0]):.2f}  speedup={cold_s / warm_s:.1f}x")

    # A material edit that CAN: E/rho only, the exact closed-form rescale.
    mat_e = AcousticMaterialProperties(mat.density * RHO_SCALE, mat.young_modulus * E_SCALE,
                                       mat.poisson_ratio, mat.alpha, mat.beta)
    t0 = time.perf_counter()
    rescaled = rescale_modes(cold.summary, cold.modes, mat_e, cfg)
    rescale_s = time.perf_counter() - t0
    expect = float(cold.modes.freqs[0]) * np.sqrt(E_SCALE / RHO_SCALE)
    if progress:
        progress(f"rescale: {rescale_s * 1e3:6.1f}ms f1={float(rescaled.freqs[0]):.2f} "
                 f"(closed-form {expect:.2f})  speedup={cold_s / max(rescale_s, 1e-9):.0f}x")
    return {"cold": cold, "cold_s": cold_s, "warm": warm, "warm_s": warm_s,
            "rescaled": rescaled, "rescale_s": rescale_s, "closed_form_f1": expect}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = edit_loop(device=device, progress=lambda line: print(line, flush=True))
    print(f"on {card_label(device)}", flush=True)
    return out


if __name__ == "__main__":
    main()
