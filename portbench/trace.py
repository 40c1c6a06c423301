"""The reading of a torch.profiler trace: the device's busy time (the union of its
operations' intervals), its operations by name, and its idle gaps named by the benchmark's
own spans.

Copied in pattern from the repository's chip_smoke.py `device_profile` and
`profile_sustained` (CPU and CUDA activities; device events are those whose device type
is CUDA: kernels, copies and sets), with the union of intervals and the naming of gaps
added here.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

WINDOW_SPAN = "portbench/window"


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Summary:
    """A traced stretch: host wall, device busy seconds, device ops {name: [count, s]},
    idle seconds by the span that was open, and how many units (solves or blocks) ran."""

    window_s: float
    busy_s: float
    ops: dict
    idle_by_span: dict
    units: int = 0  # the window's first `units` units were traced
    extra: dict = field(default_factory=dict)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    @property
    def op_count(self) -> int:
        return sum(n for n, _s in self.ops.values())

    def seconds_of(self, *needles) -> float:
        """Device seconds of the operations whose name holds any of `needles`."""
        return sum(s for name, (_n, s) in self.ops.items() if any(k in name for k in needles))

    def count_of(self, *needles) -> int:
        return sum(n for name, (n, _s) in self.ops.items() if any(k in name for k in needles))

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:160], s] for name, (_n, s) in top],
                "idle_gaps": [[name, s] for name, s in idle]}


def summarize(events, window_s: float) -> Summary:
    """Reduce profiler events (FunctionEvent-like: name, device_type, time_range in us) to
    a Summary. The traced window is the WINDOW_SPAN range; gaps inside it are named by the
    innermost benchmark span open at their midpoint."""
    from torch.autograd import DeviceType

    dev, spans, window = [], [], None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        ours = e.name == WINDOW_SPAN or e.name.split("/")[0] in ("solve", "play")
        if e.device_type == DeviceType.CUDA:
            if not ours:  # a span's range on the device timeline is not an operation
                dev.append((e.name, a, b))
        elif e.name == WINDOW_SPAN:
            window = (a, b)
        elif ours:
            spans.append((e.name, a, b))
    ops: dict = {}
    for name, a, b in dev:
        entry = ops.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) * 1e-6
    busy = union_length([(a, b) for _n, a, b in dev]) * 1e-6
    idle: dict = {}
    if window is not None:
        spans.sort(key=lambda s: s[1])
        for a, b in gaps([(a, b) for _n, a, b in dev], *window):
            mid = 0.5 * (a + b)
            open_ = [s for s in spans if s[1] <= mid <= s[2]]
            name = min(open_, key=lambda s: s[2] - s[1])[0] if open_ else "outside spans"
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return Summary(window_s=window_s, busy_s=busy, ops=ops, idle_by_span=idle)


@contextmanager
def profile_window(spans):
    """torch.profiler (CPU and CUDA activities) around the enclosed stretch, with the
    benchmark's spans recorded; yields a holder whose `summary` is set on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = type("Profiled", (), {"summary": None})()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        spans.on = True
        try:
            torch.cuda.synchronize() if torch.cuda.is_available() else None
            t0 = time.perf_counter()
            with torch.profiler.record_function(WINDOW_SPAN):
                yield holder
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            spans.on = False
    holder.summary = summarize(prof.events(), wall)
