"""Nested scope profiler + device trace hooks (reference: profile:: CPU/GPU scopes,
src/render/Profile.h:8-45, and the per-stage SolveProfile schema, mesh2modes.h:30-50).

The reference brackets frame work with CpuScope/GpuScope pairs, resolves GPU timestamp
queries after the fence, and aggregates a run summary (`Report`). Here:

- `scope("name")` — nested wall-clock scopes; `scope("name", sync=device)` waits for the
  work queued on that device (`torch.cuda.synchronize` for a CUDA device, nothing for the
  CPU) before closing, so device work is attributed to the scope that launched it (the
  fence-resolution analog). A failure of that wait is raised: it is the first place an
  asynchronous kernel fault shows. Only `enabled` makes a scope wait: under a recording
  torch.profiler alone none does, so the timeline it records is the one it measures.
- `report()` — aggregated tree (count, total, mean, %% of parent), the Report analog;
  `totals()` the same tree as flat paths.
- `records()`, `self_times()` — every closed scope as a `Span` (name, parent span,
  start, end on `time.perf_counter`) in a bounded buffer (the oldest dropped when full,
  counted by `dropped()`), and each name's count and self time: a span's duration less
  the union of its children's intervals.
- `count(name, n)`, `counts()` — event counters at the same boundaries.
- `trace(dir)` — wraps `torch.profiler.profile` (CPU and CUDA activities) and writes a
  Chrome trace into `dir` (the GPU timestamp query analog; open in chrome://tracing or
  Perfetto). While a profiler records, each scope under `solve/` or `play/` is also a
  `record_function` range, so the program's spans sit on the profiler's clock beside the
  kernels they launched. Such a range shows on the device timeline too, as a CUDA-typed
  event: `ranged(name)` tells a reader of that timeline which events are ranges, not
  device operations.

Gated by `enabled` (profile::Enabled analog) or a recording torch.profiler: otherwise
`scope()` returns one shared no-op context and `count()` returns at once, each after two
reads of a flag.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.autograd import profiler as _torch_profiler

from ._device import synchronize

enabled: bool = False

# Spans kept: a 40 s window of the busiest benchmark cell closes about 9,000 (the
# 51,402-dof torus: ~25 solves of 22 eigensolver iterations, 16 spans each); a 40 s play
# window spanned whole would close about 33,000 (5.5 spans a block).
MAX_RECORDS = 1 << 16

# The first name segments whose scopes open a profiler range; portbench/trace.py drops the
# same prefixes from the device timeline's operations.
RANGED = ("solve", "play")

_tls = threading.local()


@dataclass
class _Node:
    name: str
    count: int = 0
    total: float = 0.0
    children: dict = field(default_factory=dict)


class Span:
    """One closed scope: its name, the span open around it on its thread (None at the
    top), and its start and end on `time.perf_counter`."""

    __slots__ = ("name", "parent", "start", "end")

    def __init__(self, name: str, parent: "Span | None", start: float, end: float = 0.0):
        self.name, self.parent, self.start, self.end = name, parent, start, end


_root = _Node("root")
_records: deque = deque(maxlen=MAX_RECORDS)
_dropped = 0
_counts: dict = {}
_lock = threading.Lock()


def _stack() -> list:
    """This thread's open scopes as (tree node, span) frames, the root frame first."""
    if not hasattr(_tls, "stack"):
        _tls.stack = [(_root, None)]
    return _tls.stack


def reset() -> None:
    """Drop all collected scopes, spans and counts."""
    global _root, _dropped
    with _lock:
        _root = _Node("root")
        _records.clear()
        _dropped = 0
        _counts.clear()
    _tls.stack = [(_root, None)]


class _Off:
    """The shared context of a scope that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Scope:
    __slots__ = ("name", "sync", "stack", "frame", "marker")

    def __init__(self, name: str, sync):
        self.name, self.sync = name, sync

    def __enter__(self):
        stack = _stack()
        parent_node, parent_span = stack[-1]
        with _lock:
            node = parent_node.children.get(self.name)
            if node is None:
                node = parent_node.children[self.name] = _Node(self.name)
        self.marker = None
        if _torch_profiler._is_profiler_enabled and ranged(self.name):
            self.marker = _torch_profiler.record_function(self.name)
            self.marker.__enter__()
        self.stack, self.frame = stack, (node, Span(self.name, parent_span, time.perf_counter()))
        stack.append(self.frame)
        return None

    def __exit__(self, exc_type, exc, tb):
        global _dropped
        node, span = self.frame
        try:
            if exc_type is None and self.sync is not None and enabled:
                synchronize(torch.device(self.sync))
        finally:
            span.end = time.perf_counter()
            self.stack.pop()
            if self.marker is not None:
                self.marker.__exit__(exc_type, exc, tb)
            with _lock:
                node.count += 1
                node.total += span.end - span.start
                if len(_records) == _records.maxlen:
                    _dropped += 1
                _records.append(span)
        return False


def ranged(name: str) -> bool:
    """Whether a scope of this name opens a profiler range, which the profiler also lists
    as an event on the device timeline."""
    return name.split("/", 1)[0] in RANGED


def scope(name: str, sync=None):
    """Time a nested scope, on while `enabled` is set or a torch.profiler records. `sync`
    (a device or a device string) is waited on before closing, under `enabled` only, so
    asynchronous device work lands in this scope."""
    if not (enabled or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Scope(name, sync)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`, under the same gate as `scope`."""
    if not (enabled or _torch_profiler._is_profiler_enabled):
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    """{counter: total} since the last reset."""
    with _lock:
        return dict(_counts)


def records() -> list:
    """The buffered spans, oldest first."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans dropped from a full buffer since the last reset."""
    return _dropped


def _covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the union of `intervals` covers."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def self_times(spans=None) -> dict:
    """{name: (count, self seconds)} over `spans` (default: the buffered ones). A span's
    self time is its duration less the union of its children's intervals."""
    spans = records() if spans is None else list(spans)
    children: dict = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append((s.start, s.end))
    out: dict = {}
    for s in spans:
        n, total = out.get(s.name, (0, 0.0))
        out[s.name] = (n + 1, total + (s.end - s.start)
                       - _covered(children.get(s, ()), s.start, s.end))
    return out


@contextmanager
def trace(log_dir: str):
    """Kernel-level trace: the GPU timestamp-query analog. Yields the torch profiler and
    writes `trace.json` (Chrome trace format) into `log_dir` on exit."""
    # torch.profiler is imported here: scopes, which every solve passes, do not need it.
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def report(min_share: float = 0.0) -> str:
    """Aggregated run summary (the profile::Report analog): per scope — call count,
    total seconds, mean milliseconds, share of parent."""
    lines = ["scope                                    count   total_s   mean_ms  parent%"]

    def emit(node: _Node, depth: int, parent_total: float):
        for name, child in sorted(node.children.items(), key=lambda kv: -kv[1].total):
            share = child.total / parent_total if parent_total > 0 else 1.0
            if share < min_share:
                continue
            label = ("  " * depth + name)[:40]
            mean_ms = child.total / child.count * 1e3 if child.count else 0.0
            lines.append(
                f"{label:<40} {child.count:>5} {child.total:>9.3f} {mean_ms:>9.2f}"
                f" {share * 100:>7.1f}%"
            )
            emit(child, depth + 1, child.total)

    total = sum(c.total for c in _root.children.values())
    emit(_root, 0, total)
    return "\n".join(lines)


def totals() -> dict:
    """Flat {scope path: (count, seconds)} for programmatic checks."""
    out = {}

    def walk(node: _Node, prefix: str):
        for name, child in node.children.items():
            path = f"{prefix}/{name}" if prefix else name
            out[path] = (child.count, child.total)
            walk(child, path)

    walk(_root, "")
    return out
