"""Headline benchmark on the port (counterpart of the repo-root bench.py): eigensolve of a
10k-tet mesh to 256 modes plus one second of polyphonic modal render for 64 objects,
measured against real time on one card.

    python -m mesheditor_tpu_torch bench [--device cuda|cpu]

Prints ONE JSON line on stdout, {"metric", "value", "unit", "vs_baseline"}, where value is
the realtime factor (audio seconds rendered per wall second of solve + render), and the
detail JSON on stderr with bench.py's keys: `kernel_parity` (the impact kernel against its
plain version) in place of `pallas_parity`, and `card`, the card's name and power limit
("cpu" on the CPU), so every number carries the card it came from.

The steps are bench.py's, in its order: a warm-up solve and render (here they build the
kernel library and the tet mesher, and bring the card's libraries up), the kernel parity,
the timed solve, the timed render, the golden render and the production CDT case (the
quickstart torus meshed by the Delaunay mesher, solved warm). Any failure raises: the CDT
case too, where bench.py reports `cdt_error` instead.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

METRIC = "eigensolve_10ktet_256modes_plus_render_64obj_1s"
RMS_BAND = (8.82e-3, 9.10e-3)  # bench.py's pinned band (measured 8.9566e-3 on the reference)
PARITY_LIMIT = 1e-3  # bench.py's pallas/scan gate, max |a - b| / peak over 4096 samples
SAMPLE_RATE = 48_000.0
BLOCK = 512
SECONDS = 1.0
N_OBJECTS = 64
BOX_RESOLUTION = (18, 10, 9)  # 18*10*9 cells * 6 = 9,720 tets, 44,289 dofs
TORUS_LATTICE = 24  # the CDT case's lattice: bbox / 24
TORUS_SEGMENTS = (32, 16)  # torus_surface's defaults: 512 surface vertices


def _check(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def bench_box(resolution=BOX_RESOLUTION):
    """bench.py's mesh, solver settings and excitation points (bench.py:57-60). The
    eigenvalue-settling tolerance 1e-6 puts frequencies at ~5e-7 relative."""
    from . import SolverConfig
    from .mesh import box_tets

    mesh = box_tets((0.3, 0.16, 0.15), resolution)
    cfg = SolverConfig(num_modes=256, num_fem_modes=256, max_mode_freq=48_000.0,
                       tolerance=1e-6)
    excite = mesh.points[:: max(mesh.points.shape[0] // 10, 1)][:10]
    return mesh, cfg, excite


def strike_all(synth, result, n_objects=N_OBJECTS) -> None:
    """bench.py's strike set: one impact on each object, at sample point o mod P."""
    from .synth import ModalEvent

    for o in range(n_objects):
        synth.enqueue(ModalEvent(
            kind="impact", obj=o, expos=o % max(result.modes.shapes.shape[0], 1),
            j=(0.05, 0.02, 0.01), pulse_step=1.0 / 150.0,
            pulse_gamma=np.pi / 2 / 150.0, accel_amp=0.001,
        ))


def render_main(result, device, n_objects=N_OBJECTS, mesh=None) -> np.ndarray:
    """bench.py's build_and_render: `n_objects` instances of the result, one strike each,
    1 s in 512-sample blocks (fused into 16,384-sample calls; the synth object-sharded over
    `mesh`'s dp axis when one is given). Returns the audio on the host."""
    from .api import make_synth

    synth = make_synth([result] * n_objects, sample_rate=SAMPLE_RATE, device=device)
    if mesh is not None:
        from .parallel import shard_synth

        synth = shard_synth(synth, mesh)
    strike_all(synth, result, n_objects)
    return synth.render_seconds(SECONDS, BLOCK)


def _golden_render_rms(sample_rate, device) -> float:
    """RMS of one second rendered from a deterministic synthetic modal bank: fixed
    freqs/T60s/shapes from a seeded rng, one strike per object. Independent of the
    eigensolver, so it pins the render semantics alone (bench.py:17-38)."""
    from .api import make_synth
    from .synth import ModalEvent
    from .types import ModalModes

    rng = np.random.default_rng(20260820)
    k = 64
    modes = ModalModes(np.linspace(120.0, 9000.0, k), np.linspace(1.2, 0.15, k),
                       (rng.standard_normal((4, k, 3)) * 0.02).astype(np.float32))
    synth = make_synth([modes] * 8, sample_rate=sample_rate, device=device)
    for o in range(8):
        synth.enqueue(ModalEvent(
            kind="impact", obj=o, expos=o % 4, j=(0.04, 0.03, 0.01),
            pulse_step=1.0 / 140.0, pulse_gamma=np.pi / 2 / 140.0, accel_amp=0.0005,
        ))
    out = np.asarray(synth.render_seconds(1.0, 512), np.float64)
    return float(np.sqrt((out ** 2).mean()))


def kernel_parity(result, device, n_samples=4096) -> float:
    """The same strike set rendered for `n_samples` by two synths made from one result:
    one on `device` (through the impact kernel on a card) and one on the CPU (its plain
    version). Returns max |a - b| / peak."""
    from .api import make_synth

    outs = []
    for dev in (device, "cpu"):
        synth = make_synth([result] * N_OBJECTS, sample_rate=SAMPLE_RATE, device=dev)
        strike_all(synth, result)
        outs.append(synth.render(n_samples).cpu().numpy().astype(np.float64))
    peak = max(float(np.abs(outs[1]).max()), 1e-30)
    return float(np.abs(outs[0] - outs[1]).max() / peak)


def torus_mesh(lattice=TORUS_LATTICE, segments=TORUS_SEGMENTS):
    """The quickstart torus (0.06, 0.025) meshed by the Delaunay mesher at bbox / lattice."""
    from .mesh import torus_surface
    from .mesh.cdt import generate_tets_delaunay

    pts, tris = torus_surface(0.06, 0.025, *segments)
    h = float(np.max(pts.max(0) - pts.min(0))) / lattice
    return generate_tets_delaunay(pts, tris, lattice_h=h)


def run(report_json=True, device="cuda", box_resolution=BOX_RESOLUTION,
        torus_lattice=TORUS_LATTICE, torus_segments=TORUS_SEGMENTS):
    """The benchmark on `device`. `box_resolution`, `torus_lattice` and `torus_segments`
    (the torus surface's major and minor segments) cut the two meshes (bench.py's shapes by
    default). Returns (report, detail); with report_json the detail
    goes to stderr and the report, last, to stdout."""
    from . import SolverConfig, _build, mesh2modes
    from ._device import card_label, resolve_device
    from .materials import CERAMIC
    from .synth import impact

    device = resolve_device(device)
    card = card_label(device)

    def note(msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    mesh, cfg, excite = bench_box(box_resolution)

    def solve():
        # mesh2modes waits for the device and returns host arrays: the interval ends there
        return mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, device=device)

    # Warm-up: build the kernel library (on a card) and the tet mesher, then solve and
    # render once at the benchmark shapes.
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.load_kernels()
    _build.load_tetmesher()
    note(f"builds ready in {time.perf_counter() - t0:.2f}s ({card})")
    launches = impact.LAUNCHES
    note("warmup solve...")
    warm_result = solve()
    _check(warm_result.modes.num_modes > 0, "solve failed")
    note(f"warmup solve ok: {warm_result.modes.num_modes} modes, "
         f"{warm_result.profile.restarts} iters, iterate {warm_result.profile.iterate:.1f}s")
    warm_audio = render_main(warm_result, device)
    _check(np.isfinite(warm_audio).all() and np.abs(warm_audio).max() > 0, "render failed")
    note("warmup render ok; timing...")

    parity = kernel_parity(warm_result, device)
    note(f"kernel parity (max err / peak over 4096 samples): {parity:.3e}")
    _check(parity < PARITY_LIMIT, f"kernel/plain divergence {parity:.3e}")

    t0 = time.perf_counter()
    result = solve()
    solve_s = time.perf_counter() - t0
    note(f"timed solve {solve_s:.2f}s")

    t0 = time.perf_counter()
    audio = render_main(result, device)  # render_seconds ends in a host copy
    render_s = time.perf_counter() - t0
    note(f"timed render {render_s:.2f}s")

    total = solve_s + render_s
    realtime_x = SECONDS / total
    report = {
        "metric": METRIC,
        "value": round(realtime_x, 4),
        "unit": "x_realtime",
        "vs_baseline": round(realtime_x / 1.0, 4),
    }
    # The render's pin is a deterministic synthetic bank, not the solve's audio, which
    # rotates with degenerate mode shapes from solve to solve.
    golden_rms = _golden_render_rms(SAMPLE_RATE, device)
    _check(RMS_BAND[0] <= golden_rms <= RMS_BAND[1],
           f"golden render rms {golden_rms:.4e} outside pinned band {RMS_BAND}")
    note(f"golden render rms {golden_rms:.4e} within band {RMS_BAND}")
    audio_rms = float(np.sqrt((audio.astype(np.float64) ** 2).mean()))
    note(f"impact kernel launches: {impact.LAUNCHES - launches} "
         "(warm-up render, parity, timed render, golden render)")

    # The production (CDT) case: conforming-Delaunay meshes' irregular elements stress the
    # preconditioner differently from the structured box.
    tmesh = torus_mesh(torus_lattice, torus_segments)
    cfg_cdt = SolverConfig(num_modes=30, num_fem_modes=45)  # the quickstart's shape
    ex_cdt = tmesh.points[:: max(tmesh.points.shape[0] // 10, 1)][:10]
    note("cdt warmup solve...")
    rw = mesh2modes(tmesh, CERAMIC.properties, ex_cdt, config=cfg_cdt, device=device)
    _check(rw.modes.num_modes > 0, "cdt solve failed")
    note(f"cdt warmup ok: {rw.modes.num_modes} modes, {rw.profile.restarts} iters")
    t0 = time.perf_counter()
    rc = mesh2modes(tmesh, CERAMIC.properties, ex_cdt, config=cfg_cdt, device=device)
    cdt_s = time.perf_counter() - t0
    note(f"cdt timed solve {cdt_s:.2f}s")

    detail = {
        "solve_s": round(solve_s, 3),
        "render_s": round(render_s, 3),
        "modes": int(result.modes.num_modes),
        "dofs": result.profile.dofs,
        "eig_iterations": result.profile.restarts,
        "f1_hz": float(result.modes.freqs[0]) if result.modes.num_modes else 0.0,
        "audio_rms": audio_rms,
        "golden_render_rms": golden_rms,
        "golden_rms_band": list(RMS_BAND),
        "kernel_parity": parity,
        "cdt_solve_s": round(cdt_s, 3),
        "cdt_dofs": rc.profile.dofs,
        "cdt_iterations": rc.profile.restarts,
        "cdt_modes": int(rc.modes.num_modes),
        "cdt_f1_hz": float(rc.modes.freqs[0]) if rc.modes.num_modes else 0.0,
        "card": card,
    }
    if report_json:
        print(json.dumps(detail), file=sys.stderr)
        print(json.dumps(report), flush=True)
    return report, detail
