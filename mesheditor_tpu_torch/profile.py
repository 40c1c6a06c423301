"""Nested scope profiler + device trace hooks (reference: profile:: CPU/GPU scopes,
src/render/Profile.h:8-45, and the per-stage SolveProfile schema, mesh2modes.h:30-50).

The reference brackets frame work with CpuScope/GpuScope pairs, resolves GPU timestamp
queries after the fence, and aggregates a run summary (`Report`). Here:

- `scope("name")` — nested wall-clock scopes; `scope("name", sync=device)` waits for the
  work queued on that device (`torch.cuda.synchronize` for a CUDA device, nothing for the
  CPU) before closing, so device work is attributed to the scope that launched it (the
  fence-resolution analog). A failure of that wait is raised: it is the first place an
  asynchronous kernel fault shows.
- `report()` — aggregated tree (count, total, mean, %% of parent), the Report analog.
- `trace(dir)` — wraps `torch.profiler.profile` (CPU and CUDA activities) and writes a
  Chrome trace into `dir` (the GPU timestamp query analog; open in chrome://tracing or
  Perfetto).

Gated by `enabled` (profile::Enabled analog): disabled scopes cost one attribute read.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import torch

from ._device import synchronize

enabled: bool = False

_tls = threading.local()


@dataclass
class _Node:
    name: str
    count: int = 0
    total: float = 0.0
    children: dict = field(default_factory=dict)


_root = _Node("root")
_lock = threading.Lock()


def _stack() -> list:
    if not hasattr(_tls, "stack"):
        _tls.stack = [_root]
    return _tls.stack


def reset() -> None:
    """Drop all collected scopes."""
    global _root
    with _lock:
        _root = _Node("root")
    _tls.stack = [_root]


@contextmanager
def scope(name: str, sync=None):
    """Time a nested scope. `sync` (a device or a device string) is waited on before
    closing so asynchronous device work lands in this scope."""
    if not enabled:
        yield
        return
    stack = _stack()
    parent = stack[-1]
    with _lock:
        node = parent.children.get(name)
        if node is None:
            node = parent.children[name] = _Node(name)
    stack.append(node)
    t0 = time.perf_counter()
    try:
        yield
        if sync is not None:
            synchronize(torch.device(sync))
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            node.count += 1
            node.total += dt
        stack.pop()


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
