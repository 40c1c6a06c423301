"""Loop kind `solve`: a closed loop of warm `mesheditor_tpu_torch.mesh2modes` calls on the
configuration's box mesh, each under its own rigid motion and with its own excitation
points drawn from the seed, so that no answer can be reused and the work stays the same."""

from __future__ import annotations

import time

import numpy as np

from portbench import inputs
from portbench.reference import fem
from portbench.solving import material_dict, modes_control, record, run_solves


def run(ctx):
    from mesheditor_tpu_torch import SolverConfig, mesh2modes
    from mesheditor_tpu_torch.types import AcousticMaterialProperties, TetMesh

    cfg, tr = ctx.config, ctx.traffic
    mesh = cfg["mesh"]
    points, tets = inputs.box_tets(mesh["extents"], mesh["resolution"])
    surface = inputs.boundary_vertices(mesh["resolution"])
    mat = material_dict(cfg)
    material = AcousticMaterialProperties(mat["density"], mat["young"], mat["poisson"],
                                          mat["alpha"], mat["beta"])
    solver = cfg["solver"]
    config = SolverConfig(**solver)

    def inputs_of(i):
        return inputs.solve_call(ctx.seed, i, points, surface, cfg["excitation_points"],
                                 rotate=tr["rotate"], shift=tr["shift_m"])

    def call(i):
        moved, excite = inputs_of(i)
        t0 = time.perf_counter()
        with ctx.spans("solve/call"):
            result = mesh2modes(TetMesh(points=moved, tets=tets), material, excite,
                                config=config, device=ctx.device)
        return record(result, time.perf_counter() - t0)

    def reference(i):
        moved, excite = inputs_of(i)
        return fem.solve_modes(moved, tets, mat, excite, solver["num_modes"],
                               solver["num_fem_modes"], solver.get("min_mode_freq", 20.0),
                               solver["max_mode_freq"], np.float64)

    return run_solves(ctx, call, tr["warm_calls"], reference, ctx.cell_limits)


def small(config, traffic):
    """The CPU tests' cut: a 6x4x3 box to 40 modes, on the device engine (`small_n=0`)."""
    config["mesh"]["resolution"] = [6, 4, 3]
    config["solver"].update(num_modes=40, num_fem_modes=40, small_n=0)
    return config, traffic


def control(config, traffic, seed, limits, blocks):
    """The float32 reference against the float64 one on the seed's first window solve."""
    mesh = config["mesh"]
    points, tets = inputs.box_tets(mesh["extents"], mesh["resolution"])
    ids = inputs.boundary_vertices(mesh["resolution"])
    n_ex, sv = config["excitation_points"], config["solver"]
    args = (sv["num_modes"], sv["num_fem_modes"], sv.get("min_mode_freq", 20.0),
            sv["max_mode_freq"])
    moved, excite = inputs.solve_call(seed, 0, points, ids, n_ex, traffic["rotate"],
                                      traffic["shift_m"])
    return modes_control(moved, tets, material_dict(config), excite, args, limits)
