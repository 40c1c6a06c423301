"""A loop kind is the one place that knows how to run its cells, cut them to the CPU tests'
size and run their control: a new kind added as files alone (its loop, a configuration, a
mix, a cell and a `workloads` entry) gets its cut, its run, its result line and its
control with no file that was there changed, and a kind that lacks its cut or its control
fails with an error that names the kind, its file and the missing function."""

import copy
import hashlib
import json
import shutil

import pytest

from portbench import calibrate, harness
from portbench.tests.small import run_small, small

PROBE = {
    "run": '''
def run(ctx):
    n = ctx.config["units"]
    return Run(units=[{"wall": 0.001}] * n, window_s=0.001 * n, setup_s=0.01, attempted=n,
               failed=0, checks=[Check("probe_gap", 0.0, ctx.cell_limits["probe_gap"])],
               memory_peak_bytes=0, counters={"cut": ctx.traffic["cut"]})
''',
    "small": '''
def small(config, traffic):
    config["units"] = 2
    traffic["cut"] = True
    return config, traffic
''',
    "control": '''
def control(config, traffic, seed, limits, blocks):
    return {"probe_gap": float(seed % 7 + blocks), "units": config["units"]}
''',
}


def _add_kind(root, kind: str, without: str | None = None):
    """Add the loop kind `kind` (the probe, less the function `without`) and a cell of it
    to the checkout at `root`, as new files and one `workloads` entry."""
    pkg = root / "portbench"
    body = "".join(src for name, src in PROBE.items() if name != without)
    (pkg / "loops" / f"{kind}.py").write_text(
        f'"""Loop kind `{kind}`: a test\'s kind."""\n\n'
        f"from portbench.harness import Check, Run\n\n{body}")
    (pkg / "configs" / f"{kind}-config.json").write_text(json.dumps({"units": 5}))
    (pkg / "traffic" / f"{kind}_mix.json").write_text(json.dumps({"kind": kind, "cut": False}))
    (pkg / "cells" / f"{kind}.cell.json").write_text(json.dumps(
        {"config": f"{kind}-config", "traffic": f"{kind}_mix", "why": "a test",
         "limits": {"probe_gap": 1.0}}))
    entry = {"name": f"{kind}.cell", "config": f"{kind}-config", "traffic": f"{kind}_mix",
             "chips": 1, "why": "a loop kind added as files alone"}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return entry


def _hashes(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A copy of the benchmark (BENCHMARK.json and portbench/) that the harness reads."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    shutil.copytree(harness.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "PKG", root / "portbench")
    return root


def test_a_new_kind_is_new_files_only(checkout):
    before = _hashes(checkout)
    bench_before = json.loads((checkout / "BENCHMARK.json").read_text())
    entry = _add_kind(checkout, "probe")

    cfg, tr, limits = small("probe.cell")
    assert (cfg, tr, limits) == ({"units": 2}, {"kind": "probe", "cut": True},
                                 {"probe_gap": 1.0})
    run = run_small("probe.cell")
    assert run.attempted == 2 and run.counters == {"cut": True}
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    metrics = harness.read_metrics(run, harness.cell_metrics(bench, "probe.cell", False))
    line = harness.result_line(run, metrics, "cpu")
    assert line["correct"] is True and "setup_s" in metrics
    assert line["checks"] == {"probe_gap": {"value": 0.0, "limit": 1.0}}
    assert calibrate.control("probe.cell", 12) == {"probe_gap": 8.0, "units": 5}
    assert calibrate.control("probe.cell", 12, cfg, tr, limits, blocks=1) == \
        {"probe_gap": 6.0, "units": 2}

    after = _hashes(checkout)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    bench["workloads"].remove(entry)
    assert bench == bench_before


@pytest.mark.parametrize("missing", ["small", "control"])
def test_a_kind_without_its_cut_or_control_names_what_is_missing(checkout, missing):
    _add_kind(checkout, "bare", without=missing)
    with pytest.raises(AttributeError) as err:
        if missing == "small":
            small("bare.cell")
        else:
            calibrate.control("bare.cell", 3)
    msg = str(err.value)
    assert "'bare'" in msg and "loops/bare.py" in msg and repr(missing) in msg, msg


# What each cell's kind cuts for the CPU tests: these keys, set to these values, and no other.
CUTS = {
    "box.solve": ({"mesh": {"resolution": [6, 4, 3]},
                   "solver": {"num_modes": 40, "num_fem_modes": 40, "small_n": 0}}, {}),
    "torus.surface": ({"surface": {"n_major": 16, "n_minor": 8}, "tet_resolution": 6}, {}),
    "box.sustained": ({"play": {"objects": 4, "modes": 24}},
                      {"warm_blocks": 1, "trace_units": 2, "strike_rate": 400.0,
                       "sample_every": 0.5, "contacts": 2}),
    "box.impacts": ({"play": {"objects": 4, "modes": 24}},
                    {"warm_blocks": 1, "trace_units": 2, "strike_rate": 400.0,
                     "sample_every": 0.5}),
}


def _cut(base: dict, cut: dict) -> dict:
    out = copy.deepcopy(base)
    for key, value in cut.items():
        out[key] = {**out[key], **value} if isinstance(value, dict) else value
    return out


@pytest.mark.parametrize("cell", list(CUTS))
def test_each_cell_is_cut_to_its_sizes(cell):
    spec = harness.load_json("cells", cell)
    cfg, tr, limits = small(cell)
    want_cfg, want_tr = CUTS[cell]
    assert cfg == _cut(harness.load_json("configs", spec["config"]), want_cfg)
    assert tr == _cut(harness.load_json("traffic", spec["traffic"]), want_tr)
    assert limits == spec["limits"]
