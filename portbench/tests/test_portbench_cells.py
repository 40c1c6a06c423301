"""Every cell of BENCHMARK.json runs end to end at a small size on the CPU (the program's
plain paths) and yields the contract's result line."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.small import run_small

torch.set_num_threads(2)
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_prints_the_result_line(cell, trace):
    run = run_small(cell, trace=trace)
    metrics = harness.read_metrics(run, harness.cell_metrics(BENCH, cell, trace))
    line = harness.result_line(run, metrics, "cpu")
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in metrics
        assert len(metrics) >= 2
    json.dumps(line)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, cell, True)


def _cli(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "portbench", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_command_refuses_to_run_without_a_card():
    proc = _cli(["--workload", "box.impacts", "--seed", "5", "--seconds", "1"], harness.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_command_refuses_to_run_without_the_program(tmp_path):
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _cli(["--workload", "box.impacts", "--seed", "5", "--seconds", "1"], tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
