"""No run loads JAX or the JAX package (top-level names compared whole: the port's name
begins with the JAX package's), and the plain reference loads nothing of the program."""

import subprocess
import sys

from portbench import harness

RUN = """
import json, sys, time, torch
torch.set_num_threads(2)
from portbench import harness
from portbench.tests.small import run_small
run_small({cell!r})
print(json.dumps(harness.forbidden_modules()))
"""


def _last_json(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    for cell in ("box.impacts", "torus.surface"):
        assert _last_json(RUN.format(cell=cell)) == []


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys\n"
            "from portbench import calibrate\n"
            "from portbench.reference import bridge, compare, fem, mesher, synth\n"
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('mesheditor_tpu_torch', 'mesheditor_tpu', 'jax'))))")
    assert _last_json(code) == []


def test_names_are_compared_whole(monkeypatch):
    fake = {"mesheditor_tpu_torch": object(), "mesheditor_tpu_torch.api": object(),
            "jaxtyping": object()}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    fake["mesheditor_tpu.synth"] = object()
    fake["jax"] = object()
    assert harness.forbidden_modules() == ["jax", "mesheditor_tpu.synth"]
