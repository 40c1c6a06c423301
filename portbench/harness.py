"""The harness: finds a cell by name, runs its loop, reads its metrics and prints the
result line.

Everything that belongs to one configuration, traffic mix, cell or metric is a file of its
own, found by name:

- `cells/<cell>.json` names its configuration, its traffic mix and its loop kind;
- `configs/<config>.json` holds the configuration's sizes;
- `traffic/<traffic>.json` holds the mix's parameters, read by the loop's generator;
- `loops/<kind>.py` is all that knows a kind of traffic: it runs a cell
  (`run(ctx) -> Run`), cuts a cell to the CPU tests' size (`small(config, traffic)`, see
  tests/small.py) and runs the cell's control (`control(config, traffic, seed, limits,
  blocks)`, see calibrate.py), so a new kind is a new loop file and its data files;
- `metrics/<metric>.py` reads one metric from a Run (`read(run) -> float | None`).

Which metrics a cell reports is read from BENCHMARK.json at the checkout's root: the
end-to-end metrics with `--trace 0`, the per-layer ones with `--trace 1`, each where its
`workloads` key names the cell or where it has none.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level module names a run must not load (compared whole: the port's own name begins
# with the last one).
FORBIDDEN = ("jax", "jaxlib", "flax", "mesheditor_tpu")


def cache_dirs(root: Path = ROOT) -> dict:
    """Fixed cache directories inside the checkout for every compiler the port may reach.
    The port's own kernel and mesher builds land in build/kernels and build/native."""
    base = root / "build" / "portbench"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "CUDA_CACHE_PATH": str(base / "cuda_cache")}


def load_json(kind: str, name: str) -> dict:
    path = PKG / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """`portbench/<kind>/<name>.py` as a module (names may hold dots, so by path)."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_function(kind: str, name: str):
    """The function `name` (`run`, `small` or `control`) of the loop kind `kind`."""
    mod = load_module("loops", kind)
    fn = getattr(mod, name, None)
    if fn is None:
        raise AttributeError(f"loop kind {kind!r} ({mod.__file__}) has no function {name!r}")
    return fn


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries of BENCHMARK.json that the cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


@dataclass
class Check:
    """One number compared with the reference, beside its limit (`value <= limit`)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Run:
    """What a loop hands back: the window's units (one solve or one block each), the
    comparisons, and what tracing gathered."""

    units: list
    window_s: float
    setup_s: float
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    counters: dict = field(default_factory=dict)
    trace: object = None  # trace.Summary of the traced span, with --trace 1
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)


class Spans:
    """The benchmark's own spans around each call into the port. Off (a shared no-op
    context) unless a profiler is recording, where each becomes a record_function range
    that the trace summary uses to name idle gaps."""

    def __init__(self):
        self.on = False
        self._null = nullcontext()

    def __call__(self, name: str):
        if not self.on:
            return self._null
        import torch

        return torch.profiler.record_function(name)


@dataclass
class Context:
    """What a loop gets: its cell, configuration and traffic, the run's arguments, the
    device, the spans and the tracer."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    cell_limits: dict = field(default_factory=dict)
    spans: Spans = field(default_factory=Spans)

    @contextmanager
    def traced(self):
        """Profile the enclosed stretch with --trace 1 (a no-op otherwise). Yields a holder
        whose `summary` (a trace.Summary) is set on exit."""
        if not self.trace:
            yield type("Untraced", (), {"summary": None})()
            return
        from .trace import profile_window

        with profile_window(self.spans) as got:
            yield got


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, config: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None) -> Run:
    """Run one cell. `config`, `traffic` and `limits` replace the files' contents (the
    tests' small sizes); the device is not checked here."""
    spec = load_json("cells", cell)
    config = config if config is not None else load_json("configs", spec["config"])
    traffic = traffic if traffic is not None else load_json("traffic", spec["traffic"])
    limits = limits if limits is not None else spec["limits"]
    ctx = Context(cell, config, traffic, seed, seconds, trace, device, t_start, limits)
    run = loop_function(traffic["kind"], "run")(ctx)
    run.config, run.traffic = config, traffic
    return run


def read_metrics(run: Run, entries: list) -> dict:
    """{name: {"value", "unit"}} for each entry whose reader finds something to read."""
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(run: Run, metrics: dict, kind: str, count: int = 1) -> dict:
    checks = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    correct = bool(run.checks) and all(c.ok for c in run.checks) and run.failed == 0
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks  # last: the numbers compared, each beside its limit
    return line


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown card"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    for key, path in cache_dirs().items():
        os.environ[key] = path
        Path(path).mkdir(parents=True, exist_ok=True)
    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.is_file() or not (ROOT / "mesheditor_tpu_torch").is_dir():
        print(f"portbench: {ROOT} holds no BENCHMARK.json or no mesheditor_tpu_torch",
              file=sys.stderr)
        return 2
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available={torch.cuda.is_available()}, count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    metrics = read_metrics(run, cell_metrics(bench, args.workload, bool(args.trace)))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    line = result_line(run, metrics, torch.cuda.get_device_name(0), chips)
    walls = sorted(u["wall"] for u in run.units)
    print(f"portbench: {args.workload} on {card()}: {len(walls)} units in {run.window_s:.3f} s, "
          f"wall min {walls[0]:.6f} median {walls[len(walls) // 2]:.6f} max {walls[-1]:.6f} s, "
          f"first {[round(u['wall'], 6) for u in run.units[:3]]}, setup {run.setup_s:.3f} s",
          file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
