"""The control (the plain reference in the precision below the configuration's, put in the
program's place) fails each cell's limits, here at a small size; on the card it is run at
the cells' own sizes by `python3 -m portbench.calibrate`."""

import json

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests.small import small

torch.set_num_threads(2)
CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    cfg, tr, limits = small(cell)
    got = calibrate.control(cell, 2**31 + 99, cfg, tr, limits)
    assert any(not (v <= limits.get(k, 0)) for k, v in got.items()), got


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys

    from portbench import harness

    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload", "box.impacts",
                           "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
