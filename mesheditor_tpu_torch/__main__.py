"""Command-line surface: `python -m mesheditor_tpu_torch <command>` (counterpart of
mesheditor_tpu/__main__.py).

The headless analog of the reference's CLI (main.cpp:1387-1433 — --headless/--render/
--screenshot modes): solve meshes to modal models, render strikes to wav, inspect models,
screenshot a mesh and record a turntable, without an interactive session. `--device`
names where the solve and the renders run ("cuda" by default; "cpu" runs the plain
PyTorch path on the host). `view` and `record` take .obj/.ply meshes; glTF scenes wait
for the port of glTF import. The reference package's other commands (simulate, warmup,
bench, edit, sessions) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def cmd_solve(args):
    from .api import solve_surface
    from .io.model_store import save_modal_model
    from .materials import find_material
    from .mesh import load_obj, load_ply
    from .types import ModalSolveSettings

    mat = find_material(args.material)
    if mat is None:
        sys.exit(f"unknown material {args.material!r}")
    load = load_ply if args.mesh.endswith(".ply") else load_obj
    pts, tris = load(args.mesh)
    print(f"mesh: {pts.shape[0]} verts, {tris.shape[0]} tris; material {mat.name}")
    settings = ModalSolveSettings(
        num_modes=args.modes, num_vertices=args.vertices,
        solve_resolution=args.resolution, max_mode_freq=args.max_freq,
    )
    result = solve_surface(pts, tris, mat.properties, settings=settings,
                           tet_resolution=args.tet_resolution,
                           progress=lambda p: print(f"  progress {p:4.0%}", end="\r"),
                           device=args.device)
    if result.modes.num_modes == 0:
        sys.exit(
            "solve produced no modes in the band — small stiff objects often ring above "
            f"--max-freq (currently {args.max_freq:.0f} Hz); try raising it"
        )
    path = save_modal_model(args.out_dir, result.modes, result.mass_props)
    prof = result.profile
    print(f"\nsolved {result.modes.num_modes} modes, f1 {result.modes.freqs[0]:.1f} Hz, "
          f"mass {result.mass_props.mass:.3f} kg")
    print(f"profile: assemble {prof.assemble:.2f}s iterate {prof.iterate:.2f}s "
          f"({prof.restarts} iterations, {prof.dofs} dofs)")
    print(f"model -> {path}")


def cmd_render(args):
    import numpy as np
    import torch

    from .api import make_synth
    from .io import load_modal_model, write_wav

    modes, _mass = load_modal_model(args.model)
    synth = make_synth([modes], device=args.device)
    rng = np.random.default_rng(args.seed)
    times = sorted(rng.uniform(0, max(args.seconds - 0.3, 0.01), args.strikes))
    block = 512
    total_blocks = int(np.ceil(args.seconds * 48000 / block))
    strike_blocks = {int(t * 48000 // block) for t in times}
    out = []
    for b in range(total_blocks):
        if b in strike_blocks or b == 0:
            expos = int(rng.integers(0, max(modes.shapes.shape[0], 1)))
            synth.strike(0, expos, rng.normal(0, 0.04, 3), 2e-3)
        out.append(synth.render(block))
    audio = torch.cat(out).cpu().numpy()
    peak = max(float(np.abs(audio).max()), 1e-9)
    write_wav(args.out, audio / peak * 0.9)
    print(f"rendered {args.seconds}s ({args.strikes} strikes) -> {args.out} (peak {peak:.4f})")


def cmd_info(args):
    from .io.model_store import load_modal_model

    modes, mass = load_modal_model(args.model)
    print(f"modes: {modes.num_modes}  sample points: {modes.shapes.shape[0]}")
    print(f"mass: {mass.mass:.4f} kg  fundamental: {modes.original_fundamental_freq:.1f} Hz")
    for k in range(min(modes.num_modes, 12)):
        print(f"  mode {k:2d}: {modes.freqs[k]:9.2f} Hz  T60 {modes.t60s[k]*1e3:8.1f} ms")


def _load_mesh(path):
    from .mesh import load_obj, load_ply

    if path.endswith((".gltf", ".glb")):
        sys.exit(f"{path}: glTF import is not ported yet; give an .obj or .ply mesh")
    load = load_ply if path.endswith(".ply") else load_obj
    return load(path)


def cmd_record(args):
    """Fixed-step turntable recording (the reference's --record capture,
    main.cpp CLI + VideoRecorder)."""
    from .render import RenderSettings
    from .render.record import record, turntable_frames

    settings = RenderSettings(width=args.width, height=args.height, mode=args.mode)
    pts, tris = _load_mesh(args.scene)
    out = record(args.out, turntable_frames(pts, tris, n_frames=args.frames,
                                            settings=settings, device=args.device),
                 fps=args.fps)
    print(f"wrote {out} ({args.frames} frames @ {args.fps} fps)")


def cmd_view(args):
    """Screenshot a mesh through the rasterizer (the reference's --screenshot/--headless
    render path, main.cpp:1387-1433)."""
    from .render import RenderSettings, render_mesh, save_png
    from .render.camera import frame_points

    settings = RenderSettings(width=args.width, height=args.height, mode=args.mode,
                              supersample=args.supersample)
    pts, tris = _load_mesh(args.scene)
    cam = frame_points(pts, azimuth_deg=args.azimuth, elevation_deg=args.elevation)
    img = render_mesh(pts, tris, camera=cam, settings=settings, device=args.device)
    print(f"mesh: {pts.shape[0]} verts, {tris.shape[0]} tris")
    save_png(args.out, img)
    print(f"wrote {args.out} ({settings.width}x{settings.height}, {settings.mode})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mesheditor_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("solve", help="mesh (obj/ply) -> content-addressed modal model")
    s.add_argument("mesh")
    s.add_argument("--material", default="Ceramic")
    s.add_argument("--modes", type=int, default=30)
    s.add_argument("--vertices", type=int, default=10)
    s.add_argument("--resolution", type=float, default=1.0)
    s.add_argument("--max-freq", type=float, default=16000.0)
    s.add_argument("--tet-resolution", type=int, default=24)
    s.add_argument("--out-dir", default="modal")
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_solve)

    r = sub.add_parser("render", help="modal model -> strike-rendered wav")
    r.add_argument("model")
    r.add_argument("--out", default="render.wav")
    r.add_argument("--seconds", type=float, default=2.0)
    r.add_argument("--strikes", type=int, default=4)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda")
    r.set_defaults(fn=cmd_render)

    i = sub.add_parser("info", help="inspect a modal model file")
    i.add_argument("model")
    i.set_defaults(fn=cmd_info)

    modes = ["smooth", "flat", "wireframe", "wireframe_only"]
    rec = sub.add_parser("record", help="turntable-record a mesh to png frames/gif/mp4")
    rec.add_argument("scene", help=".obj/.ply")
    rec.add_argument("--out", default="turntable.gif",
                     help=".gif (needs PIL), .mp4 (needs ffmpeg; else .gif) or .png frames")
    rec.add_argument("--frames", type=int, default=36)
    rec.add_argument("--fps", type=float, default=12.0)
    rec.add_argument("--width", type=int, default=480)
    rec.add_argument("--height", type=int, default=360)
    rec.add_argument("--mode", default="smooth", choices=modes)
    rec.add_argument("--device", default="cuda")
    rec.set_defaults(fn=cmd_record)

    v = sub.add_parser("view", help="screenshot a mesh (obj/ply) to PNG")
    v.add_argument("scene")
    v.add_argument("--out", default="view.png")
    v.add_argument("--width", type=int, default=960)
    v.add_argument("--height", type=int, default=720)
    v.add_argument("--mode", default="smooth", choices=modes)
    v.add_argument("--supersample", type=int, default=2)
    v.add_argument("--azimuth", type=float, default=-60.0)
    v.add_argument("--elevation", type=float, default=25.0)
    v.add_argument("--device", default="cuda")
    v.set_defaults(fn=cmd_view)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
