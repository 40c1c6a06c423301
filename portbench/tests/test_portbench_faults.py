"""The comparison that decides `correct` fails when the timed path is broken underneath: a
run at a small size on the CPU, with the program's answer altered where it is produced,
its state left unchanged by a step, or half its objects left out of the mix."""

import importlib

import numpy as np
import pytest
import torch

from portbench.tests.small import run_small

torch.set_num_threads(2)


def _failed(run) -> list:
    return [c.name for c in run.checks if not c.ok]


def test_sound_runs_pass():
    for cell in ("box.solve", "box.sustained", "box.impacts", "torus.surface"):
        assert not _failed(run_small(cell)), cell


@pytest.mark.parametrize("cell", ["box.solve", "torus.surface"])
def test_a_frequency_altered_where_it_is_produced_fails(cell, monkeypatch):
    m2m = importlib.import_module("mesheditor_tpu_torch.solve.mesh2modes")

    real = m2m.postprocess_modes

    def altered(*args, **kwargs):
        modes = real(*args, **kwargs)
        modes.freqs = modes.freqs.copy()
        modes.freqs[len(modes.freqs) // 2] *= np.float32(1 + 1e-4)
        return modes

    monkeypatch.setattr(m2m, "postprocess_modes", altered)
    assert "freq_rel" in _failed(run_small(cell))


def test_a_gain_altered_where_it_is_produced_fails(monkeypatch):
    m2m = importlib.import_module("mesheditor_tpu_torch.solve.mesh2modes")

    real = m2m.postprocess_modes

    def altered(*args, **kwargs):
        modes = real(*args, **kwargs)
        modes.shapes = modes.shapes * np.float32(1.05)
        return modes

    monkeypatch.setattr(m2m, "postprocess_modes", altered)
    assert "gain_rel" in _failed(run_small("box.solve"))


def _patch_block(monkeypatch, wrap):
    """Wrap both block renders (the route every block takes) with `wrap(result, args)`."""
    from mesheditor_tpu_torch.synth import coupled, impact

    for mod, name in ((impact, "render_block_impacts"), (coupled, "render_block_coupled")):
        real = getattr(mod, name)

        def patched(*args, _real=real, **kwargs):
            return wrap(_real(*args, **kwargs), args)

        monkeypatch.setattr(mod, name, patched)


@pytest.mark.parametrize("cell", ["box.sustained", "box.impacts"])
def test_a_step_that_leaves_its_state_unchanged_fails(cell, monkeypatch):
    def frozen(result, args):
        return (args[1], *result[1:])  # the state passed in, returned as it was

    _patch_block(monkeypatch, frozen)
    assert "state_rel" in _failed(run_small(cell))


@pytest.mark.parametrize("cell", ["box.sustained", "box.impacts"])
def test_half_the_objects_left_out_fails(cell, monkeypatch):
    from mesheditor_tpu_torch.synth import engine

    real = engine.render_block

    def half(params, state, *args, **kwargs):
        n = params.coeff_re.shape[0]
        keep = (torch.arange(n) < (n + 1) // 2).to(torch.float32)[:, None]
        p = type(params)(params.coeff_re * keep, params.coeff_im * keep, params.disp_scale,
                         params.shapes, params.out_gain * 2 * keep[:, 0], params.sample_rate)
        return real(p, state, *args, **kwargs)

    monkeypatch.setattr(engine, "render_block", half)
    failed = _failed(run_small(cell))
    assert "block_rel" in failed and "state_rel" in failed


@pytest.mark.parametrize("cell", ["box.sustained", "box.impacts"])
def test_a_sample_altered_where_it_is_produced_fails(cell, monkeypatch):
    def altered(result, args):
        out = result[-1].clone()
        out[len(out) // 2] += 1e-2 * out.abs().max()
        return (*result[:-1], out)

    _patch_block(monkeypatch, altered)
    assert "block_rel" in _failed(run_small(cell))
