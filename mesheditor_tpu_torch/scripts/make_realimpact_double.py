"""Write a synthetic double of one RealImpact object directory (counterpart of
scripts/make_realimpact_double.py).

The dataset itself (128 GB; 2.3 GiB of deconvolved audio an object) is not in the repo,
so this writes an object directory in the npy layout that the loader and the reference
read (reference: src/audio/RealImpact.cpp:12-23; row order RealImpact.h:9-23):

  <out>/<id>_<Name>/preprocessed/
    angle.npy distance.npy micID.npy listenerXYZ.npy   (600 listener rows: mic-major,
                                                        then distance, then angle)
    vertexXYZ.npy vertexID.npy                         (3000 rows; the impact vertex
                                                        repeats every 600 rows)
    deconvolved_0db.npy                                (3000, frames) float32 at 48 kHz
    transformed.obj                                    (Z-up scan mesh)

The scan is a jittered hemispherical bowl with a 5% wall. Its "recordings" are damped
sinusoids at the modal frequencies of an independent scipy shift-invert solve of the same
mesh, weighted per impact vertex by the mode shapes, scaled by listener distance, over a
-60 dB noise floor. A harness that solves the mesh through the port's own pipeline must
then find the recorded partials at its rendered partials, which checks the loader, the
ordering, the axes, the vertex matching, the solve, the synthesis and the scoring without
holding the solve under test to itself.

Numpy and scipy only: the mesher is the port's build, the pencil the port's assembly on
the host.

Usage: python -m mesheditor_tpu_torch.scripts.make_realimpact_double [outdir]
       [--frames N] [--full] [--detune X] [--tet-resolution N]
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from ..materials import find_material
from ..mesh import bowl_surface
from ..mesh.obj_io import save_obj

SR = 48_000
FULL_FRAMES = 209_715  # ~4.37 s, the real dataset's clip length
NUM_LISTENERS = 600
NUM_IMPACTS = 5


def scipy_reference_modes(points, tris, material, tet_resolution=20, n_modes=25):
    """Modal frequencies and shapes from scipy's shift-invert over the port's mesher and
    assembly. Returns (tet mesh, freqs, eigenvalues, eigenvectors, quad mesh). ARPACK
    starts from a fixed vector (seed 0, as the solve's host path does), so the answer does
    not follow the solves run before it."""
    import scipy.sparse.linalg as spla

    from ..fem.assembly import assemble_element_matrices, filter_degenerate
    from ..fem.quad_mesh import build_quad_mesh
    from ..mesh.cdt import generate_tets_delaunay
    from ..solve.lobpcg import _pencil_csr

    h = float(np.ptp(np.asarray(points), axis=0).max()) / tet_resolution
    tm = generate_tets_delaunay(points, tris, lattice_h=h)
    kept = filter_degenerate(tm.points, tm.tets)
    quad = build_quad_mesh(kept, tm.points.shape[0])
    ops = assemble_element_matrices(tm.points, kept, material, quad, device="cpu")
    k, m = _pencil_csr(ops)
    sigma = -((2 * np.pi * 20.0) ** 2)
    v0 = np.random.default_rng(0).uniform(-1.0, 1.0, k.shape[0])
    vals, vecs = spla.eigsh(k, k=n_modes + 6, M=m, sigma=sigma, which="LM", v0=v0)
    order = np.argsort(vals)
    vals, vecs = vals[order], vecs[:, order]
    live = vals > (2 * np.pi * 20.0) ** 2  # drop the rigid-body modes
    vals, vecs = vals[live][:n_modes], vecs[:, live][:, :n_modes]
    freqs = np.sqrt(vals) / (2 * np.pi)
    return tm, freqs, vals, vecs, quad


def synth_recordings(freqs, vals, vecs, tm, impact_positions, material, frames):
    """(5, frames) base clips: each impact vertex's modal excitation, Rayleigh-damped
    sinusoids, each clip normalized to a peak of 1."""
    t = np.arange(frames) / SR
    omega = 2 * np.pi * freqs
    c = material.alpha + material.beta * vals  # Rayleigh damping (mesh2modes.cpp:515-588)
    clips = np.zeros((NUM_IMPACTS, frames), np.float32)
    pts = np.asarray(tm.points)
    for v in range(NUM_IMPACTS):
        # The modal velocity response to an impulse at the struck vertex goes as
        # phi_k(v)^2 / omega_k for mass-normalized modes, the law the bank's gains follow.
        vid = int(np.argmin(((pts - impact_positions[v]) ** 2).sum(1)))
        phi = np.linalg.norm(vecs[3 * vid : 3 * vid + 3, :], axis=0)
        amp = phi * phi / np.maximum(omega, 1.0)
        amp = amp / max(amp.max(), 1e-30)
        sig = np.zeros(frames)
        for k in range(freqs.size):
            sig += amp[k] * np.sin(omega[k] * t) * np.exp(-0.5 * c[k] * t)
        clips[v] = (sig / max(np.abs(sig).max(), 1e-30)).astype(np.float32)
    return clips


def make_double(outdir, name="53_CeramicKoiBowl", frames=2 * SR, detune=0.0,
                tet_resolution=10, n_modes=25, bowl_kw=None, seed=11):
    """Write one synthetic object directory; returns its path."""
    d = Path(outdir) / name / "preprocessed"
    d.mkdir(parents=True, exist_ok=True)

    # The scan: a hemispherical bowl shell with a 5% wall, vertex-jittered, Z-up (the
    # bowl's axis is z), in metres (the loader scales the listeners from mm, nothing else).
    bowl_kw = bowl_kw or dict(radius=0.06, thickness=0.003, n_lat=8, n_lon=20,
                              noise=0.08)
    pts, tris = bowl_surface(seed=seed, **bowl_kw)
    save_obj(d / "transformed.obj", pts, tris)

    material = find_material("Ceramic").properties
    print("solving scipy reference modes...", flush=True)
    tm, freqs, vals, vecs, _ = scipy_reference_modes(
        pts, tris, material, tet_resolution=tet_resolution, n_modes=n_modes)
    print(f"  {freqs.size} modes, f1={freqs[0]:.1f} Hz, fmax={freqs[-1]:.1f} Hz")
    if detune:
        freqs = freqs * (1.0 + detune)
        vals = (2 * np.pi * freqs) ** 2

    # Listeners: mic-major, then distance, then angle (RealImpact.h:9-23).
    mics = np.repeat(np.arange(15), 40)
    distances = np.tile(np.repeat(np.array([250, 500, 750, 1000]), 10), 15)
    angles = np.tile(np.arange(10) * 36, 60)
    heights = 40.0 * np.arange(15) + 100.0  # mic stack, mm
    az = np.deg2rad(angles)
    listener = np.stack([distances * np.cos(az), distances * np.sin(az),
                         heights[mics]], 1).astype(np.float64)  # Z-up, mm
    np.save(d / "angle.npy", angles.astype(np.int64))
    np.save(d / "distance.npy", distances.astype(np.int64))
    np.save(d / "micID.npy", mics.astype(np.int64))
    np.save(d / "listenerXYZ.npy", listener)

    # Impact vertices: 5 outer-surface points spread in latitude and azimuth, the spots
    # the rig's solenoid reaches (RealImpact.h:25-38); vertexXYZ repeats every 600 rows.
    # The outer rings come first in bowl_surface's vertex order (rim toward pole), and the
    # last two rings are left out: the rig cannot strike the face the object rests on, and
    # points next to the pole carry almost none of the fundamental.
    n_lat, n_lon = bowl_kw.get("n_lat", 8), bowl_kw.get("n_lon", 20)
    rings = np.linspace(0, n_lat - 3, NUM_IMPACTS).astype(np.int64)
    ids = np.asarray([r * n_lon + (r * 7) % n_lon for r in rings], np.int64)
    impact_xyz = pts[ids]  # Z-up, obj units
    np.save(d / "vertexXYZ.npy", np.repeat(impact_xyz, NUM_LISTENERS, axis=0))
    np.save(d / "vertexID.npy", np.repeat(ids, NUM_LISTENERS))

    print("synthesizing base clips...", flush=True)
    clips = synth_recordings(freqs, vals, vecs, tm, impact_xyz, material, frames)

    # The whole matrix, written block by block through a memmap: row = listener + 600*impact.
    path = d / "deconvolved_0db.npy"
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                    shape=(NUM_LISTENERS * NUM_IMPACTS, frames))
    rng = np.random.default_rng(2026)
    gain = (250.0 / distances).astype(np.float32)  # inverse-distance level
    for i in range(NUM_IMPACTS):
        block = gain[:, None] * clips[i][None, :]
        block = block + 1e-3 * rng.standard_normal(block.shape).astype(np.float32)
        out[NUM_LISTENERS * i : NUM_LISTENERS * (i + 1)] = block
        print(f"  impact {i}: rows {NUM_LISTENERS * i}..{NUM_LISTENERS * (i + 1) - 1}",
              flush=True)
    out.flush()
    del out
    print(f"wrote {path} ({os.path.getsize(path) / 2**30:.2f} GiB)")
    print(f"object dir: {d.parent}")
    return d.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default="realimpact_double")
    ap.add_argument("--frames", type=int, default=2 * SR)
    ap.add_argument("--full", action="store_true",
                    help=f"real-scale clips ({FULL_FRAMES} frames, 2.34 GiB)")
    ap.add_argument("--detune", type=float, default=0.0,
                    help="fractional frequency detune of the recordings (control runs)")
    ap.add_argument("--tet-resolution", type=int, default=10)
    args = ap.parse_args(argv)
    name = "53_CeramicKoiBowl" if not args.detune else "54_CeramicKoiBowlDetuned"
    return make_double(args.outdir, name=name,
                       frames=FULL_FRAMES if args.full else args.frames,
                       detune=args.detune, tet_resolution=args.tet_resolution)


if __name__ == "__main__":
    main()
