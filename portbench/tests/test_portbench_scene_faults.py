"""The scene cell's comparison fails when its path is broken underneath: a run of
falling8.scene at a small size on the CPU, with a physics step that leaves a body's state as
it was, an impact report dropped, a block's sample altered, or reconcile solving with another
material, to other settings or with other mass properties, each made where the value is
produced."""

import torch

from mesheditor_tpu_torch.physics.world import PhysicsWorld
from portbench.tests.small import run_small

torch.set_num_threads(2)
CELL = "falling8.scene"


def _failed(run) -> list:
    return [c.name for c in run.checks if not c.ok]


def _patch_step(monkeypatch, after):
    """Wrap PhysicsWorld.step with `after(world, state before)`."""
    real = PhysicsWorld.step

    def step(world):
        before = {h: (b.pos.copy(), b.quat.copy(), b.vel.copy(), b.ang.copy())
                  for h, b in world.bodies.items()}
        real(world)
        after(world, before)

    monkeypatch.setattr(PhysicsWorld, "step", step)


def test_a_sound_run_passes():
    run = run_small(CELL)
    assert not _failed(run), run.checks
    assert run.counters["checked_steps"] >= 3 and run.counters["checked_blocks"]
    for held in ("impact_steps", "impact_blocks", "voiced_blocks"):
        assert run.counters[held] >= 1, run.counters


def test_a_step_that_leaves_a_body_as_it_was_fails(monkeypatch):
    def frozen(world, before):
        b = world.bodies[3]  # the first block, thrown down at the floor
        b.pos, b.quat, b.vel, b.ang = before[3]

    _patch_step(monkeypatch, frozen)
    failed = _failed(run_small(CELL))
    assert "pose_rel" in failed and "vel_rel" in failed


def test_a_dropped_impact_report_fails(monkeypatch):
    def dropped(world, _before):
        if world.impacts:
            world.impacts.pop()

    _patch_step(monkeypatch, dropped)
    assert "reports" in _failed(run_small(CELL))


def test_a_sample_altered_where_it_is_produced_fails(monkeypatch):
    from mesheditor_tpu_torch.synth import coupled, impact

    for mod, name in ((impact, "render_block_impacts"), (coupled, "render_block_coupled")):
        real = getattr(mod, name)

        def altered(*args, _real=real, **kwargs):
            *rest, out = _real(*args, **kwargs)
            out = out.clone()
            out[len(out) // 2] += 1e-2 * out.abs().max()
            return (*rest, out)

        monkeypatch.setattr(mod, name, altered)
    assert "block_rel" in _failed(run_small(CELL))


def test_a_model_solved_with_another_material_fails(monkeypatch):
    from dataclasses import replace

    from mesheditor_tpu_torch.scene.audio_sync import SceneAudio

    real = SceneAudio._material

    def stiffer(self, e):
        m = real(self, e)
        return replace(m, young_modulus=m.young_modulus * 1.02)

    monkeypatch.setattr(SceneAudio, "_material", stiffer)
    assert "freq_rel" in _failed(run_small(CELL))


def test_a_model_solved_to_other_settings_fails(monkeypatch):
    from dataclasses import replace

    from mesheditor_tpu_torch.scene.audio_sync import SceneAudio

    real = SceneAudio._settings
    monkeypatch.setattr(SceneAudio, "_settings",
                        lambda self, e: replace(real(self, e), num_modes=29))
    assert "modes" in _failed(run_small(CELL))


def test_other_mass_properties_fail(monkeypatch):
    import importlib
    from dataclasses import replace

    mesh2modes = importlib.import_module("mesheditor_tpu_torch.solve.mesh2modes")
    real = mesh2modes.compute_mass_properties
    monkeypatch.setattr(mesh2modes, "compute_mass_properties",
                        lambda *a, **k: replace(real(*a, **k), mass=real(*a, **k).mass * 1.01))
    assert "mass_rel" in _failed(run_small(CELL))
