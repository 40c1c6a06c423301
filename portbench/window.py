"""The measured window: a closed loop that runs the next unit (one solve, one block) when
the last one has returned, until the window's seconds are spent. With --trace 1 the
profiler records the window's first `trace_units` units (whatever the time they
take), which bounds the trace's size."""

from __future__ import annotations

import time


def closed_loop(ctx, step, trace_units: int):
    """Run step(i) for i = 0, 1, ... until ctx.seconds have passed since the first began
    (the unit under way is finished). Returns (units, window_s, trace summary or None)."""
    units, summary = [], None
    t0 = time.perf_counter()
    if ctx.trace:
        with ctx.traced() as got:
            while len(units) < trace_units:
                units.append(step(len(units)))
        summary = got.summary
        summary.units = len(units)
    while time.perf_counter() - t0 < ctx.seconds:
        units.append(step(len(units)))
    return units, time.perf_counter() - t0, summary


def memory_peak(device: str) -> int:
    """The device's peak of allocated bytes over the run so far (0 on the CPU)."""
    import torch

    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
