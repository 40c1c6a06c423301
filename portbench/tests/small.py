"""Each cell at a size the CPU runs in seconds: the tests' stand-in for the files."""

from __future__ import annotations

import time

from portbench import harness


def small(cell: str):
    """(config, traffic, limits) of `cell`, cut to a CPU test's size."""
    spec = harness.load_json("cells", cell)
    cfg = harness.load_json("configs", spec["config"])
    tr = harness.load_json("traffic", spec["traffic"])
    if tr["kind"] == "solve":
        cfg["mesh"]["resolution"] = [6, 4, 3]
        cfg["solver"].update(num_modes=40, num_fem_modes=40, small_n=0)
    elif tr["kind"] == "surface":
        cfg["surface"].update(n_major=16, n_minor=8)
        cfg["tet_resolution"] = 6
    else:
        cfg["play"].update(objects=4, modes=24)
        tr.update(warm_blocks=1, trace_units=2, strike_rate=400.0, sample_every=0.5)
        if tr.get("contacts"):
            tr["contacts"] = 2
    return cfg, tr, dict(spec["limits"])


def run_small(cell: str, seed: int = 2**31 + 17, seconds: float = 0.5, trace: bool = False,
              limits=None):
    cfg, tr, lim = small(cell)
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                            config=cfg, traffic=tr, limits=limits or lim)
