"""RealImpact comparison harness: recorded impacts against the modal model, BASELINE
config 3 (counterpart of scripts/realimpact_harness.py).

For each object directory under REALIMPACT_DATASET_DIR (or --dataset):
  1. load the scan (mesh, impact vertices, material);
  2. simplify, tetrahedralize (the Delaunay mesher, the voxel mesher when it cannot) and
     solve the modes on --device;
  3. retune the model so that its fundamental is the recording's (the reference's
     FundamentalFreq workflow, AudioSystem.cpp:827-866);
  4. strike each recorded impact vertex, render through the impact kernel on the card,
     and score the fraction of the recording's top partials that lie within --cents of a
     rendered partial.

Each object prints its solve (dofs, iterations, the path that answered: the device engine
or the host shift-invert, modes, wall), each impact's f0 and score, and the impact kernel's
launches (0 on the CPU, where the renders take the kernel's plain version).

Writes a wav pair (recorded, modal) per impact with --out. Prints the reference's skip
line when the dataset is absent. An object the mesher cannot mesh (its ValueError) or
whose solve returns no mode is reported and the next object runs; any other error ends
the run with a non-zero exit.

Usage: python -m mesheditor_tpu_torch.scripts.realimpact_harness [--dataset DIR]
       [--listener N] [--cents C] [--out DIR] [--tet-resolution N] [--objects NAME...]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np


def top_partials(signal, sr, k=8, fmin=60.0, fmax=12000.0):
    """The `k` strongest spectral peaks of `signal` in [fmin, fmax] Hz, strongest first,
    each at least 20 Hz from the ones before it."""
    spec = np.abs(np.fft.rfft(signal * np.hanning(len(signal))))
    freqs = np.fft.rfftfreq(len(signal), 1 / sr)
    band = (freqs >= fmin) & (freqs <= fmax)
    spec = np.where(band, spec, 0)
    peaks = np.flatnonzero((spec[1:-1] > spec[:-2]) & (spec[1:-1] > spec[2:])) + 1
    peaks = peaks[np.argsort(spec[peaks])[::-1]][: k * 3]
    out = []
    for p in peaks:
        if all(abs(freqs[p] - f) > 20 for f in out):
            out.append(float(freqs[p]))
        if len(out) >= k:
            break
    return out


def run_object(obj_dir, listener, cents, out_dir, tet_resolution, device="cuda"):
    """Solve one object and score each recorded impact against its retuned strike. Returns
    the mean partial-match score, or None when the scan could not be meshed (the mesher's
    ValueError) or the solve returned no mode; both are reported. Anything else raises."""
    from ..api import make_synth, solve_surface, strike
    from ..io import write_wav
    from ..io.realimpact import SAMPLE_RATE, load_realimpact_scan, load_samples
    from ..materials import find_material
    from ..solve import lobpcg
    from ..solve.orchestration import estimate_fundamental
    from ..solve.postprocess import postprocess_modes
    from ..synth import impact
    from ..types import ModalSolveSettings, SolverConfig

    scan = load_realimpact_scan(obj_dir)
    mat = find_material(scan.material_name or "Ceramic")
    print(f"== {scan.object_name} ({mat.name}) "
          f"{scan.positions.shape[0]} verts {scan.triangles.shape[0]} tris", flush=True)
    settings = ModalSolveSettings(num_modes=60, solve_resolution=0.5, max_mode_freq=16000.0)
    answered = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
    t0 = time.perf_counter()
    try:
        result = solve_surface(
            scan.positions, scan.triangles, mat.properties,
            excite_positions=scan.impact_positions, settings=settings,
            tet_resolution=tet_resolution, device=device,
        )
    except ValueError as e:  # neither mesher could mesh the scan
        print(f"   {Path(obj_dir).name}: FAILED {e}", flush=True)
        return None
    wall = time.perf_counter() - t0
    path = ("device" if lobpcg.DEVICE_SOLVES > answered[0] else
            "host" if lobpcg.HOST_SOLVES > answered[1] else "none")
    print(f"   solve: {result.profile.dofs} dofs, {result.profile.restarts} iterations, "
          f"answered by {path}, {result.modes.num_modes} modes, {wall:.3f} s", flush=True)
    if result.modes.num_modes == 0:
        print("   solve failed", flush=True)
        return None
    samples = load_samples(obj_dir, listener)
    launches = impact.LAUNCHES
    scores = []
    for imp in range(samples.shape[0]):
        rec = samples[imp]
        f0 = estimate_fundamental(rec, SAMPLE_RATE, min_freq=60.0)
        # Retune the model to the recording's fundamental: the material and the mesh
        # shift the absolute pitch, and the reference offers the same workflow.
        cfg = SolverConfig(num_modes=60, max_mode_freq=16000.0,
                           fundamental_freq=f0 if f0 > 0 else None)
        modes = postprocess_modes(
            result.summary.eigenvalues, result.summary.shapes, 1.0,
            mat.properties, cfg, result.modes.positions,
        )
        synth = make_synth([modes], device=device)
        expos = (int(result.sample_point_of_excitation[imp])
                 if result.sample_point_of_excitation.size > imp else 0)
        strike(synth, 0, expos, result, direction=(0, 1, 0), impulse_mag=0.05,
               material=mat.properties)
        model_audio = synth.render_seconds(min(len(rec) / SAMPLE_RATE, 2.0))
        rec_partials = top_partials(rec[: len(model_audio)], SAMPLE_RATE)
        model_partials = top_partials(model_audio, SAMPLE_RATE)
        hits = 0
        for rp in rec_partials:
            if any(abs(1200 * np.log2(mp / rp)) < cents for mp in model_partials if mp > 0):
                hits += 1
        score = hits / max(len(rec_partials), 1)
        scores.append(score)
        print(f"   impact {imp}: f0={f0:7.1f} Hz match {hits}/{len(rec_partials)} partials "
              f"(within {cents} cents)", flush=True)
        if out_dir:
            out = Path(out_dir)
            out.mkdir(parents=True, exist_ok=True)
            peak = max(np.abs(model_audio).max(), 1e-9)
            write_wav(out / f"{scan.object_name}_{imp}_modal.wav", model_audio / peak)
            write_wav(out / f"{scan.object_name}_{imp}_recorded.wav",
                      rec[: len(model_audio)] / max(np.abs(rec).max(), 1e-9))
    print(f"   impact kernel launches: {impact.LAUNCHES - launches}", flush=True)
    return float(np.mean(scores)) if scores else None


def main(argv=None):
    from .._device import card_label, resolve_device
    from ..io.realimpact import validate_directory

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default=os.environ.get("REALIMPACT_DATASET_DIR", ""))
    ap.add_argument("--listener", type=int, default=263)  # front-center
    ap.add_argument("--cents", type=float, default=60.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--tet-resolution", type=int, default=28)
    ap.add_argument("--objects", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    root = Path(args.dataset)
    if not args.dataset or not root.exists():
        print("RealImpact dataset not found; skipping (set REALIMPACT_DATASET_DIR)")
        return {}
    dirs = [d for d in sorted(root.iterdir()) if d.is_dir() and validate_directory(d)]
    if args.objects:
        dirs = [d for d in dirs if any(o in d.name for o in args.objects)]
    print(f"on {card_label(device)}", flush=True)
    results = {}
    for d in dirs:
        score = run_object(d, args.listener, args.cents, args.out, args.tet_resolution,
                           device)
        if score is not None:
            results[d.name] = score
    if results:
        print("\nmean partial-match score:", round(float(np.mean(list(results.values()))), 3))
    return results


if __name__ == "__main__":
    main()
