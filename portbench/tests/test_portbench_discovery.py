"""The harness finds a cell, a configuration, a traffic mix and a metric by name: added
files are taken up with no edit of any file already there."""

import json
import shutil

from portbench import harness
from portbench.tests.small import small


def test_added_files_are_found_without_an_edit(tmp_path, monkeypatch):
    pkg = tmp_path / "portbench"
    shutil.copytree(harness.PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(harness, "PKG", pkg)
    cfg, tr, limits = small("box.impacts")
    cfg["play"]["objects"] = 3
    (pkg / "configs" / "box-three.json").write_text(json.dumps(cfg))
    tr["strike_rate"] = 200.0
    (pkg / "traffic" / "strikes_slow.json").write_text(json.dumps(tr))
    (pkg / "cells" / "box.three.json").write_text(json.dumps(
        {"config": "box-three", "traffic": "strikes_slow", "why": "a test", "limits": limits}))
    (pkg / "metrics" / "blocks_run.py").write_text("def read(run):\n    return len(run.units)\n")
    bench = {"end_to_end": [{"name": "blocks_run", "unit": "blocks"},
                            {"name": "setup_s", "unit": "s"}], "per_layer": []}
    run = harness.run_cell("box.three", 7, 0.3, False, "cpu", 0.0)
    assert run.config["play"]["objects"] == 3 and run.traffic["strike_rate"] == 200.0
    metrics = harness.read_metrics(run, harness.cell_metrics(bench, "box.three", False))
    assert metrics["blocks_run"]["value"] == len(run.units) >= 1
    assert "setup_s" in metrics


def test_a_metric_listed_for_other_cells_is_not_read():
    bench = {"end_to_end": [{"name": "solve_s", "workloads": ["box.solve"]},
                            {"name": "setup_s"}], "per_layer": []}
    names = [m["name"] for m in harness.cell_metrics(bench, "box.impacts", False)]
    assert names == ["setup_s"]


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    run = harness.Run(units=[], window_s=1.0, setup_s=1.0, attempted=0, failed=0, checks=[],
                      memory_peak_bytes=0)
    got = harness.read_metrics(run, [{"name": "idle.play", "unit": "%"},
                                     {"name": "coupled_roofline", "unit": "%"}])
    assert got == {}
