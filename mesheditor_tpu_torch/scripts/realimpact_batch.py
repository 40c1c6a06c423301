"""RealImpact corpus batch solve: every object directory under a root, solved through the
full pipeline with per-object SolveProfile rows, then one OBJECT-SHARDED verification
render over the ranks (counterpart of scripts/realimpact_batch.py).

The reference's corpus bench walks 50 RealImpact + 60 Thingi10k scans and prints per-case
rows (ModalSolverBench.cpp:28-80). Here the per-object solves run one after another on
--device (each solve is itself device-parallel), and the final check (every object's bank
rows excited by one unit impulse, one block rendered) deals the objects over the dp axis
of a mesh of --devices ranks, the DealObjects analog (SURVEY.md §2.8): one process a rank
(parallel/launch.py:spawn), NCCL with one card a rank on the card, gloo on the CPU.

Usage: python -m mesheditor_tpu_torch.scripts.realimpact_batch <corpus_root>
       [--tet-resolution N] [--modes N] [--devices N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def batch_solve(root, tet_resolution=10, n_modes=30, progress=print, device="cuda"):
    """Solve every RealImpact object dir under `root` on `device`. Returns (rows,
    results)."""
    from ..api import solve_surface
    from ..io.realimpact import load_realimpact_scan, validate_directory
    from ..materials import find_material
    from ..types import ModalSolveSettings

    dirs = sorted(d for d in (os.path.join(root, x) for x in os.listdir(root))
                  if os.path.isdir(d) and validate_directory(d))
    rows, results = [], []
    for d in dirs:
        scan = load_realimpact_scan(d)
        mat = find_material(scan.material_name or "Ceramic")
        t0 = time.perf_counter()
        res = solve_surface(
            scan.positions, scan.triangles, mat.properties,
            excite_positions=scan.impact_positions,
            settings=ModalSolveSettings(num_modes=n_modes, num_vertices=10,
                                        max_mode_freq=20_000.0),
            tet_resolution=tet_resolution, device=device,
        )
        wall = time.perf_counter() - t0
        p = res.profile
        row = {
            "object": scan.object_name, "material": scan.material_name,
            "dofs": p.dofs, "k_nnz": p.stiffness_nonzeros,
            "modes": res.modes.num_modes,
            "f1_hz": float(res.modes.freqs[0]) if res.modes.num_modes else 0.0,
            "solve_s": round(wall, 2),
            "stage_s": {"mesh": round(p.quad_mesh, 2), "assemble": round(p.assemble, 2),
                        "factorize": round(p.factorize, 2), "iterate": round(p.iterate, 2),
                        "extract": round(p.extract, 2)},
            "eig_iterations": p.restarts,
        }
        rows.append(row)
        results.append(res)
        if progress:
            progress(f"{row['object']}: {row['dofs']} dofs, "
                     f"{row['modes']} modes, f1={row['f1_hz']:.1f} Hz, "
                     f"{row['solve_s']}s {row['stage_s']}")
    return rows, results


def _verification_rank(device, modes_list, block):
    """One rank of the verification render: this rank's contiguous block of the bank's
    objects advanced from rest under a unit impulse at sample 0, the mono mix summed over
    the dp axis. Returns the (block,) mix on the host."""
    from ..parallel.sharding import batched_render_step, make_mesh
    from ..synth.bank import build_bank

    mesh = make_mesh(None, axis_names=("dp",), device=device)
    params, _state = build_bank(modes_list, sample_rate=48_000.0, device=device)
    c_re, c_im = params.coeff_re, params.coeff_im
    excite = torch.zeros(block, dtype=torch.float32, device=device)
    excite[0] = 1.0
    step = batched_render_step(mesh, axis="dp")
    _z_re, _z_im, out = step(torch.zeros_like(c_re), torch.zeros_like(c_im), c_re, c_im,
                             params.out_gain, excite)
    return out.cpu().numpy().astype(np.float32)


def sharded_verification_render(results, n_devices=None, block=512, device="cuda"):
    """One block of audio with every solved object's bank rows excited by a unit impulse,
    the objects sharded over the dp axis of a mesh of `n_devices` ranks (every card on
    "cuda", one process on "cpu", when None) and the mono mix all-reduced. The ranks run
    under NCCL, one card each, on "cuda" and under gloo on "cpu". Returns the (block,)
    mono mix as float32."""
    from .._device import resolve_device
    from ..parallel.launch import spawn

    device = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    backend = "nccl" if device.type == "cuda" else "gloo"
    mixes = spawn(_verification_rank, n_devices, device=device, backend=backend,
                  args=([r.modes for r in results], block))
    return mixes[0]


def main(argv=None):
    from .._device import card_label, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--tet-resolution", type=int, default=10)
    ap.add_argument("--modes", type=int, default=30)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows, results = batch_solve(args.root, args.tet_resolution, args.modes, device=device)
    mix = None
    if results:
        mix = sharded_verification_render(results, args.devices, device=device)
        ok = bool(np.isfinite(mix).all() and np.abs(mix).max() > 0)
        print(f"sharded verification render: {len(results)} objects, "
              f"|mix|max={np.abs(mix).max():.3e}, ok={ok}")
    print(f"on {card_label(device)}")
    print(json.dumps(rows, indent=1), flush=True)
    return rows, mix


if __name__ == "__main__":
    main()
