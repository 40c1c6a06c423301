"""Loop kind `surface`: a closed loop of `mesheditor_tpu_torch.api.solve_surface` calls,
surface in, modal model out, each on the configuration's surface under its own rigid
shift and with its own excitation vertices drawn from the seed. A shift keeps the mesher's
lattice where it is relative to the surface (it is anchored at the bounding box), so every
call meshes to the same tets; a rotation would change the mesh and so the work."""

from __future__ import annotations

import time

import numpy as np

from portbench import inputs
from portbench.reference import fem, mesher
from portbench.solving import material_dict, modes_control, record, run_solves


def run(ctx):
    from mesheditor_tpu_torch.api import solve_surface
    from mesheditor_tpu_torch.types import AcousticMaterialProperties, ModalSolveSettings

    cfg, tr = ctx.config, ctx.traffic
    surf = cfg["surface"]
    pts, tris = inputs.torus_surface(surf["major"], surf["minor"], surf["n_major"],
                                     surf["n_minor"])
    mat = material_dict(cfg)
    material = AcousticMaterialProperties(mat["density"], mat["young"], mat["poisson"],
                                          mat["alpha"], mat["beta"])
    settings = ModalSolveSettings(**cfg["settings"])
    resolution = cfg["tet_resolution"]
    all_ids = np.arange(pts.shape[0])

    def inputs_of(i):
        return inputs.solve_call(ctx.seed, i, pts, all_ids, settings.num_vertices,
                                 rotate=tr["rotate"], shift=tr["shift_m"])

    def call(i):
        moved, excite = inputs_of(i)
        t0 = time.perf_counter()
        with ctx.spans("solve/call"):
            result = solve_surface(moved, tris, material, excite_positions=excite,
                                   settings=settings, tet_resolution=resolution,
                                   device=ctx.device)
        return record(result, time.perf_counter() - t0)

    def reference(i):
        moved, excite = inputs_of(i)
        span = float((moved.max(0) - moved.min(0)).max())
        tet_pts, tets = mesher.delaunay(moved, tris, span / resolution)
        n = settings.num_modes
        return fem.solve_modes(tet_pts, tets, mat, excite, n, max(n + 15, n * 3 // 2),
                               settings.min_mode_freq, settings.max_mode_freq, np.float64)

    return run_solves(ctx, call, tr["warm_calls"], reference, ctx.cell_limits)


def small(config, traffic):
    """The CPU tests' cut: the torus at 16x8 surface segments, tets at bbox/6."""
    config["surface"].update(n_major=16, n_minor=8)
    config["tet_resolution"] = 6
    return config, traffic


def control(config, traffic, seed, limits, blocks):
    """The float32 reference against the float64 one on the seed's first window solve,
    each on the reference mesher's tets of the moved surface."""
    s = config["surface"]
    points, tris = inputs.torus_surface(s["major"], s["minor"], s["n_major"], s["n_minor"])
    ids, st = np.arange(len(points)), config["settings"]
    n_ex, nm = st["num_vertices"], st["num_modes"]
    args = (nm, max(nm + 15, nm * 3 // 2), st["min_mode_freq"], st["max_mode_freq"])
    moved, excite = inputs.solve_call(seed, 0, points, ids, n_ex, traffic["rotate"],
                                      traffic["shift_m"])
    span = float((moved.max(0) - moved.min(0)).max())
    moved, tets = mesher.delaunay(moved, tris, span / config["tet_resolution"])
    return modes_control(moved, tets, material_dict(config), excite, args, limits)
