"""What the two solve loops share: the per-solve record, the window, and the comparison
of one solve drawn from the seed (and the frequencies of every solve) with the plain
reference, which runs once the window has closed."""

from __future__ import annotations

import sys
import time

import numpy as np

from . import inputs
from .harness import Check, Run
from .reference import compare, fem
from .window import closed_loop, memory_peak

PROFILE_FIELDS = ("mass_props", "quad_mesh", "assemble", "sample_excite", "factorize",
                  "iterate", "extract", "restarts", "dofs")


def material_dict(cfg: dict) -> dict:
    return {k: float(v) for k, v in cfg["material"].items() if k != "name"}


def record(result, wall: float) -> dict:
    """One solve's record: its wall, the SolveProfile's stages and counts, its answer."""
    p = result.profile
    unit = {"wall": wall, **{f: getattr(p, f) for f in PROFILE_FIELDS}}
    m = result.modes
    unit["modes"] = {"freqs": np.asarray(m.freqs, np.float64),
                     "t60s": np.asarray(m.t60s, np.float64),
                     "shapes": np.asarray(m.shapes, np.float64)}
    return unit


def modes_control(points, tets, mat: dict, excite, args: tuple, limits: dict) -> dict:
    """A solve kind's control: the float32 reference against the float64 one on the same
    tets and excitation, by the cell's numbers. `args` is fem.solve_modes's (num_modes,
    num_fem_modes, min_mode_freq, max_mode_freq)."""
    ref = fem.solve_modes(points, tets, mat, excite, *args, np.float64)
    low = fem.solve_modes(points, tets, mat, excite, *args, np.float32)
    checks = compare.modes_checks({"modes": low, "dofs": low["dofs"]}, ref, limits)
    return {c.name: c.value for c in checks}


def run_solves(ctx, call, warm_calls: int, reference, limits: dict) -> Run:
    """Warm up with `warm_calls` calls of inputs no window call gets, run the window, then
    compare. `call(i)` runs the i-th solve (negative i: warm-up) and returns its record;
    `reference(i)` is the plain reference's answer for the i-th solve's inputs."""
    for w in range(warm_calls):
        call(-1 - w)
    setup_s = time.perf_counter() - ctx.t_start
    if ctx.trace:
        from mesheditor_tpu_torch import profile

        profile.reset()
        profile.enabled = True  # the program's own scopes (the mesher's wall), trace only
    units, window_s, summary = closed_loop(ctx, call, ctx.traffic["trace_units"])
    peak = memory_peak(ctx.device)
    if ctx.trace:
        from mesheditor_tpu_torch import profile

        profile.enabled = False
        counters = {"scopes": profile.totals()}
    else:
        counters = {}
    failed = sum(1 for u in units if not compare.answered(u["modes"]))
    j = int(inputs.rng(ctx.seed, inputs.SAMPLE).integers(len(units)))
    if ctx.device == "cuda":
        import torch

        torch.cuda.empty_cache()  # the program's cached blocks, before the reference's
    t0 = time.perf_counter()
    ref = reference(j)
    f = ref["freqs"]
    print(f"portbench: reference of solve {j}: {ref['dofs']} dofs, {len(f)} modes, "
          f"{f[0] if len(f) else 0:.3f}-{f[-1] if len(f) else 0:.3f} Hz, "
          f"{time.perf_counter() - t0:.1f} s, {fem.lowest_pairs.last}", file=sys.stderr,
          flush=True)
    checks = compare.modes_checks(units[j], ref, limits)
    checks.append(Check("freq_all", max(compare.freq_rel(u["modes"], ref) for u in units),
                        limits["freq_rel"]))
    return Run(units=units, window_s=window_s, setup_s=setup_s, attempted=len(units),
               failed=failed, checks=checks, memory_peak_bytes=peak,
               counters={**counters, "sampled": j}, trace=summary)
