"""Command-line surface: `python -m mesheditor_tpu_torch <command>` (counterpart of
mesheditor_tpu/__main__.py).

The headless analog of the reference's CLI (main.cpp:1387-1433 — --headless/--render/
--screenshot modes): solve meshes to modal models, render strikes to wav, inspect models,
simulate a glTF scene to audio (and video), screenshot and record a mesh or a glTF scene,
and list or restore crash-recovery sessions, without an interactive session; `edit` serves
the interactive viewer/editor to a browser, `bench` runs the headline benchmark
(bench.py), and `warmup` builds what the port builds at first use and runs the standard
shapes once. `--device` names where the solves and the renders run ("cuda" by default;
"cpu" runs the plain PyTorch path on the host).
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


def cmd_simulate(args):
    import tempfile

    import numpy as np

    from .io import write_wav
    from .io.gltf import import_gltf
    from .scene.audio_sync import simulate_scene

    store = args.store or tempfile.mkdtemp(prefix="mesheditor_tpu_store_")
    reg = import_gltf(args.scene, store_dir=store)
    print(f"scene: {len(reg.entities())} entities; store {store}")
    frames = []
    on_frame = None
    if args.video:
        from .render import RenderSettings, render_scene
        from .render.camera import frame_points

        # Frame the WORLD-space scene at t=0 with headroom for motion.
        cam = frame_points(_world_points(reg), margin=2.2)
        settings = RenderSettings(width=args.video_width, height=args.video_height)

        def on_frame(r, i):
            frames.append(render_scene(r, camera=cam, settings=settings,
                                       device=args.device).image())

    audio = simulate_scene(
        reg, store, seconds=args.seconds, tet_resolution=args.tet_resolution,
        progress=lambda p: print(f"  solve progress {p:4.0%}", end="\r"),
        on_frame=on_frame, video_fps=args.video_fps, device=args.device,
    )
    peak = max(float(np.abs(audio).max()), 1e-9)
    write_wav(args.out, audio / peak * 0.9)
    print(f"simulated {args.seconds}s of physics audio -> {args.out} (peak {peak:.4f})")
    if args.video and frames:
        from .render.record import record

        p = record(args.video, frames, fps=args.video_fps)
        print(f"video: {len(frames)} frames -> {p}")


def cmd_info(args):
    from .io.model_store import load_modal_model

    modes, mass = load_modal_model(args.model)
    print(f"modes: {modes.num_modes}  sample points: {modes.shapes.shape[0]}")
    print(f"mass: {mass.mass:.4f} kg  fundamental: {modes.original_fundamental_freq:.1f} Hz")
    for k in range(min(modes.num_modes, 12)):
        print(f"  mode {k:2d}: {modes.freqs[k]:9.2f} Hz  T60 {modes.t60s[k]*1e3:8.1f} ms")


def cmd_sessions(args):
    """Crash-recovery sessions: list restore dirs, replay one, or verify replay
    determinism (reference: File > Restore, main.cpp:928-938; self-test :409-423)."""
    from .scene.session import SessionStore, verify_replay

    store = SessionStore(args.root)
    if args.action == "list":
        sessions = store.list()
        if not sessions:
            print("no sessions")
            return
        for d in sessions:
            n_actions = sum(1 for line in open(d / "actions.log")) if (
                d / "actions.log").exists() else 0
            print(f"{d.name}: {n_actions} actions")
    elif args.action == "restore":
        from .scene.components import Name

        d = store.list()[-1] if args.session is None else store.root / args.session
        r = store.restore(d)
        names = [r.get(e, Name).value for e in r.entities() if r.has(e, Name)]
        print(f"restored {d.name}: {len(names)} named objects: {names[:16]}")
        if args.out:
            from .io.project import save_project

            save_project(args.out, r)
            print(f"saved {args.out}")
        fixture = verify_replay(r, d)
        print("replay self-test:", "byte-exact" if fixture is None else f"DIVERGED -> {fixture}")


def _world_points(r):
    """The world-space vertices of a registry's drawn meshes, on the host."""
    from .render.scene_render import world_points

    r.process()
    return world_points(r)


def _is_gltf(path) -> bool:
    return str(path).endswith((".gltf", ".glb"))


def _load_mesh(path):
    from .mesh import load_obj, load_ply

    load = load_ply if path.endswith(".ply") else load_obj
    return load(path)


def cmd_record(args):
    """Fixed-step turntable recording of a mesh or a glTF scene (the reference's --record
    capture, main.cpp CLI + VideoRecorder)."""
    from .render import RenderSettings
    from .render.record import record, turntable_cameras, turntable_frames
    from .render.scene_render import render_scene

    settings = RenderSettings(width=args.width, height=args.height, mode=args.mode)
    if _is_gltf(args.scene):
        from .io.gltf import import_gltf

        r = import_gltf(args.scene)
        # Frame the WORLD-space scene. (The reference frames the meshes' local positions,
        # which misses every body placed away from the origin.)
        frames = (render_scene(r, camera=cam, settings=settings, device=args.device).image()
                  for cam in turntable_cameras(_world_points(r), args.frames))
        out = record(args.out, frames, fps=args.fps)
    else:
        pts, tris = _load_mesh(args.scene)
        out = record(args.out, turntable_frames(pts, tris, n_frames=args.frames,
                                                settings=settings, device=args.device),
                     fps=args.fps)
    print(f"wrote {out} ({args.frames} frames @ {args.fps} fps)")


def cmd_view(args):
    """Screenshot a mesh or a glTF scene through the rasterizer (the reference's
    --screenshot/--headless render path, main.cpp:1387-1433)."""
    from .render import RenderSettings, render_mesh, render_scene, save_png
    from .render.camera import frame_points

    settings = RenderSettings(width=args.width, height=args.height, mode=args.mode,
                              supersample=args.supersample)
    if _is_gltf(args.scene):
        from .io.gltf import import_gltf

        r = import_gltf(args.scene)
        view = render_scene(r, settings=settings, device=args.device)
        img = view.image()
        n = len(view.batch.entities)
        print(f"scene: {n} mesh entities, {view.batch.triangles.shape[0]} triangles")
        if args.debug_physics:
            from .physics.scene_build import build_world
            from .render.debug_draw import draw_physics_debug

            world, _ = build_world(r)
            if world.bodies:
                img = draw_physics_debug(img, world, view.camera)
                print(f"debug overlay: {len(world.bodies)} collider wireframes")
    else:
        pts, tris = _load_mesh(args.scene)
        cam = frame_points(pts, azimuth_deg=args.azimuth, elevation_deg=args.elevation)
        img = render_mesh(pts, tris, camera=cam, settings=settings, device=args.device)
        print(f"mesh: {pts.shape[0]} verts, {tris.shape[0]} tris")
    save_png(args.out, img)
    print(f"wrote {args.out} ({settings.width}x{settings.height}, {settings.mode})")


def cmd_edit(args):
    """Interactive viewer/editor served to a browser (reference: the windowed app,
    main.cpp:847-1185). Frames, solves and the strike's audio run on --device; a .project
    loads as a project, any other file as glTF."""
    from .app import ViewerApp, serve

    registry = None
    if args.scene:
        if str(args.scene).endswith(".project"):
            from .io.project import load_project

            registry = load_project(args.scene)
        else:
            from .io.gltf import import_gltf

            registry = import_gltf(args.scene)
    app = ViewerApp(registry, width=args.width, height=args.height, audio=args.audio,
                    device=args.device)
    serve(app, port=args.port)


def cmd_warmup(args):
    """Build the kernel library (on the card) and the tet mesher into build/, where every
    later process loads them instead of compiling, then run the chosen shape set once: the
    first process's start-up, paid here (reference: cmd_warmup, which primes the XLA compile
    cache instead)."""
    import time

    from . import _build
    from ._device import resolve_device

    device = resolve_device(args.device)
    t_all = time.perf_counter()
    jobs = [("tet mesher", _build.load_tetmesher)]
    if device.type == "cuda":  # a CPU run never loads the kernels
        jobs.insert(0, ("kernel library", _build.load_kernels))
    if args.set in ("quickstart", "all"):
        jobs.append(("quickstart torus solve + render", lambda: _warm_quickstart(device)))
    if args.set in ("bench", "all"):
        jobs.append(("bench box solve + 64-object render", lambda: _warm_bench(device)))
    for name, fn in jobs:
        t0 = time.perf_counter()
        print(f"warming {name}...", flush=True)
        fn()
        print(f"  {name}: {time.perf_counter() - t0:.1f}s", flush=True)
    print(f"warmup done in {time.perf_counter() - t_all:.1f}s on {device}")


def _warm_quickstart(device):
    import numpy as np

    from .api import make_synth, solve_surface, strike
    from .materials import CERAMIC
    from .mesh import torus_surface
    from .types import ModalSolveSettings

    pts, tris = torus_surface(0.06, 0.025)
    res = solve_surface(pts, tris, CERAMIC.properties,
                        settings=ModalSolveSettings(num_modes=30), device=device)
    synth = make_synth([res], device=device)
    strike(synth, 0, 0, res, direction=(0, 1, 0), impulse_mag=0.05)
    audio = synth.render_seconds(1.0)
    if not np.isfinite(audio).all():
        raise RuntimeError("the quickstart render is not finite")
    print(f"  {res.modes.num_modes} modes, f1 {res.modes.freqs[0]:.1f} Hz, "
          f"{res.profile.dofs} dofs")


def _warm_bench(device):
    """The headline benchmark once, without its report (bench.py's shapes: the 9,720-tet box
    to 256 modes, 64 strikes rendered for 1 s, the golden render, the CDT torus)."""
    from . import bench

    _report, detail = bench.run(report_json=False, device=device)
    print(f"  {detail['modes']} modes, f1 {detail['f1_hz']:.1f} Hz, {detail['dofs']} dofs")


def cmd_bench(args):
    """Headline benchmark: eigensolve of the 10k-tet box to 256 modes plus a 64-object
    second of render, against real time (the reference's `bench`, which runs bench.py)."""
    from . import bench

    bench.run(device=args.device)


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

    sim = sub.add_parser("simulate", help="glTF scene -> physics-driven audio wav")
    sim.add_argument("scene", help=".gltf/.glb with KHR_physics/audio_rigid_bodies")
    sim.add_argument("--seconds", type=float, default=3.0)
    sim.add_argument("--out", default="simulation.wav")
    sim.add_argument("--store", default=None, help="modal model store dir")
    sim.add_argument("--tet-resolution", type=int, default=24)
    sim.add_argument("--video", default=None,
                     help="also record the simulation (.png frames; .gif needs PIL, "
                          ".mp4 ffmpeg)")
    sim.add_argument("--video-fps", type=float, default=30.0)
    sim.add_argument("--video-width", type=int, default=480)
    sim.add_argument("--video-height", type=int, default=360)
    sim.add_argument("--device", default="cuda")
    sim.set_defaults(fn=cmd_simulate)

    i = sub.add_parser("info", help="inspect a modal model file")
    i.add_argument("model")
    i.set_defaults(fn=cmd_info)

    modes = ["smooth", "flat", "wireframe", "wireframe_only"]
    ses = sub.add_parser("sessions", help="list/restore crash-recovery sessions")
    ses.add_argument("action", choices=["list", "restore"])
    ses.add_argument("session", nargs="?", default=None,
                     help="session dir name (default: most recent)")
    ses.add_argument("--root", default=None, help="session root dir override")
    ses.add_argument("--out", default=None, help="save restored scene as .project")
    ses.set_defaults(fn=cmd_sessions)

    rec = sub.add_parser("record", help="turntable-record a mesh or a glTF scene to png "
                                        "frames/gif/mp4")
    rec.add_argument("scene", help=".obj/.ply/.gltf/.glb")
    rec.add_argument("--out", default="turntable.gif",
                     help=".gif (needs PIL), .mp4 (needs ffmpeg; else .gif) or .png frames")
    rec.add_argument("--frames", type=int, default=36)
    rec.add_argument("--fps", type=float, default=12.0)
    rec.add_argument("--width", type=int, default=480)
    rec.add_argument("--height", type=int, default=360)
    rec.add_argument("--mode", default="smooth", choices=modes)
    rec.add_argument("--device", default="cuda")
    rec.set_defaults(fn=cmd_record)

    v = sub.add_parser("view", help="screenshot a mesh or a scene (obj/ply/gltf) to PNG")
    v.add_argument("scene")
    v.add_argument("--out", default="view.png")
    v.add_argument("--width", type=int, default=960)
    v.add_argument("--height", type=int, default=720)
    v.add_argument("--mode", default="smooth", choices=modes)
    v.add_argument("--supersample", type=int, default=2)
    v.add_argument("--azimuth", type=float, default=-60.0)
    v.add_argument("--elevation", type=float, default=25.0)
    v.add_argument("--debug-physics", action="store_true",
                   help="overlay collider wireframes (glTF scenes)")
    v.add_argument("--device", default="cuda")
    v.set_defaults(fn=cmd_view)

    b = sub.add_parser("bench", help="headline benchmark: 10k-tet solve + 64-object render "
                                     "vs real time")
    b.add_argument("--device", default="cuda")
    b.set_defaults(fn=cmd_bench)

    wu = sub.add_parser("warmup", help="build the kernels and the mesher, run standard "
                                       "shapes once")
    wu.add_argument("--set", default="quickstart", choices=["quickstart", "bench", "all"],
                    help="which shape set to run (default: quickstart)")
    wu.add_argument("--device", default="cuda")
    wu.set_defaults(fn=cmd_warmup)

    ed = sub.add_parser("edit", help="interactive browser viewer/editor")
    ed.add_argument("scene", nargs="?", default=None, help="glTF/.project to open")
    ed.add_argument("--port", type=int, default=8731, help="0 binds a free port (printed)")
    ed.add_argument("--audio", action="store_true",
                    help="solve modal models at the first strike; strike mode plays audio")
    ed.add_argument("--width", type=int, default=960)
    ed.add_argument("--height", type=int, default=600)
    ed.add_argument("--device", default="cuda")
    ed.set_defaults(fn=cmd_edit)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
