"""Each cell at a size the CPU runs in seconds: the tests' stand-in for the files. The cut
is the cell's loop kind's own (`small(config, traffic)` in `loops/<kind>.py`), so a new
kind brings its cut in its loop file and this file knows no kind."""

from __future__ import annotations

import time

from portbench import harness


def small(cell: str):
    """(config, traffic, limits) of `cell`, cut to a CPU test's size."""
    spec = harness.load_json("cells", cell)
    cfg = harness.load_json("configs", spec["config"])
    tr = harness.load_json("traffic", spec["traffic"])
    cfg, tr = harness.loop_function(tr["kind"], "small")(cfg, tr)
    return cfg, tr, dict(spec["limits"])


def run_small(cell: str, seed: int = 2**31 + 17, seconds: float = 0.5, trace: bool = False,
              limits=None):
    cfg, tr, lim = small(cell)
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                            config=cfg, traffic=tr, limits=limits or lim)
