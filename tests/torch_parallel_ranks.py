"""What each rank of tests/test_torch_parallel.py runs, and the scenes it shares with the
unsharded runs there. It imports only the port (a rank is a fresh process that unpickles
`run_rank` by this module's name), never JAX or the JAX package."""

import numpy as np
import torch

from mesheditor_tpu_torch import SolverConfig, mesh2modes
from mesheditor_tpu_torch.api import make_synth
from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                      filter_degenerate)
from mesheditor_tpu_torch.materials import CERAMIC
from mesheditor_tpu_torch.mesh import bar_tets
from mesheditor_tpu_torch.parallel import (batched_render_step, make_mesh, shard_elements,
                                           shard_synth, sharded_pencil_ops,
                                           sharded_subspace_step)
from mesheditor_tpu_torch.synth import ContactTrackSpec, ModalEvent, SustainedVoice
from mesheditor_tpu_torch.synth.tracks import synthesize_roughness
from mesheditor_tpu_torch.types import ModalModes

SIGMA = -((2 * np.pi * 20.0) ** 2)
# tests/test_parallel.py:TestProductionSolveSharded's bar and configuration.
SOLVE_CFG = SolverConfig(num_modes=12, num_fem_modes=16, small_n=0, tolerance=1e-10,
                         max_mode_freq=96_000.0)
VOICED_BLOCKS = 3
CARRIES = ("age", "prev_height", "relief_mean", "penetration", "primed", "active", "obj")


def pencil(device="cpu"):
    """tests/test_parallel.py:_pencil's bar (no orphan dofs: the fixes are zero)."""
    bar = bar_tets(0.2, 0.05, 0.05, 4, 2, 2)
    kept = filter_degenerate(bar.points, bar.tets)
    quad = build_quad_mesh(kept, bar.points.shape[0])
    return assemble_element_matrices(bar.points, kept, CERAMIC.properties, quad, device=device)


def panel(n_dofs, cols, seed):
    return np.random.default_rng(seed).standard_normal((n_dofs, cols))


def render_bank(n_obj=16, k=8, s=64):
    """tests/test_parallel.py:TestShardedRender._bank, float64 numpy."""
    rng = np.random.default_rng(3)
    z = np.zeros((n_obj, k))
    c_re = np.full((n_obj, k), 0.995)
    c_im = rng.uniform(0.01, 0.1, (n_obj, k))
    gains = rng.uniform(0.5, 1.5, n_obj)
    excite = rng.standard_normal(s)
    return z, c_re, c_im, gains, excite


def solve_bar():
    bar = bar_tets(0.2, 0.06, 0.05, 7, 3, 3)
    return bar, bar.points[:: max(bar.points.shape[0] // 6, 1)][:6]


def synth_modes():
    """tests/test_parallel.py:TestProductionRenderSharded's model (8 objects of it)."""
    rng = np.random.default_rng(5)
    k = 24
    return ModalModes(np.linspace(100.0, 6000.0, k), np.linspace(1.0, 0.2, k),
                      (rng.standard_normal((4, k, 3)) * 0.02).astype(np.float32))


def strike_all(synth, n_obj=8, accel_amp=0.001):
    for o in range(n_obj):
        synth.enqueue(ModalEvent(kind="impact", obj=o, expos=o % 4, j=(0.05, 0.02, 0.01),
                                 pulse_step=1 / 96.0, pulse_gamma=np.pi / 2 / 96.0,
                                 accel_amp=accel_amp))


def scrape(synth, obj, voice_id=1):
    """The dry run's scrape voice and roughness track on `obj`."""
    slot = synth.adopt_track(7, lambda: synthesize_roughness(1e-4, -2.0, 1e-6))
    return SustainedVoice(
        voice_id=voice_id, obj=obj, blend_points=(0, 1, 0), blend_weights=(0.5, 0.5, 0.0),
        normal=(0.0, 1.0, 0.0), slip_dir=(1.0, 0.0, 0.0),
        sweep_dir=((1.0, 0.0, 0.0), (0.0, 0.0, -1.0)), normal_force=0.6, friction=0.5,
        stiffness=2e5, static_penetration=3e-6, damping_coeff=0.4,
        tracks=tuple(ContactTrackSpec(index=slot, rate=0.4, sigma=2e-7, window=8.0,
                                      step=4e-7) for _ in range(4)))


def voiced_render(synth):
    """Strikes with a loud click on every object, scrape voices on objects 1 and 6 (other
    ranks' objects at every world > 1), VOICED_BLOCKS blocks of 256 with a publish before
    each. Returns (mix, the voice table's carries)."""
    strike_all(synth, accel_amp=1.0)
    voices = [scrape(synth, 1), scrape(synth, 6, voice_id=2)]
    out = []
    for _ in range(VOICED_BLOCKS):
        synth.publish_voices(voices)
        out.append(synth.render(256).cpu().numpy())
    table = synth.voices.to_numpy()
    return np.concatenate(out), {f: table[f] for f in CARRIES}


def run_rank(device, world):
    """Every case at one world size, on this rank. Returns numpy results."""
    out = {}
    # Matvecs and the subspace step: the bar's elements over a 1-D tp mesh of every rank.
    tp = make_mesh(world, ("tp",), device=device)
    ops = pencil()
    ed, kb, rv = shard_elements(ops.elem_dofs.numpy(), ops.k_blocks.numpy(),
                                ops.rho_vol.numpy(), tp)
    kmat, mmat = sharded_pencil_ops(tp, ed, kb, rv, ops.m_unit.numpy(), ops.n_dofs)
    x = torch.as_tensor(panel(ops.n_dofs, 6, 0))
    out["kx"], out["mx"] = kmat(x).numpy(), mmat(x).numpy()
    step = sharded_subspace_step(tp, kmat, mmat)
    x1, theta1 = step(torch.as_tensor(panel(ops.n_dofs, 8, 2)), SIGMA)
    _x2, theta2 = step(x1, SIGMA)
    out["theta"] = (theta1.numpy(), theta2.numpy())

    # The batched render step over a 1-D dp mesh.
    dp = make_mesh(world, ("dp",), device=device)
    for n_obj in (16, 8):
        z, c_re, c_im, gains, excite = (torch.as_tensor(a) for a in render_bank(n_obj))
        _zr, _zi, mix = batched_render_step(dp)(z, z, c_re, c_im, gains, excite)
        out[f"step{n_obj}"] = mix.numpy()

    # The production solve, element-sharded, on the device engine and below small_n.
    bar, ex = solve_bar()
    res = mesh2modes(bar, CERAMIC.properties, ex, config=SOLVE_CFG, mesh=tp)
    out["solve"] = (res.summary.eigenvalues, res.modes.freqs, res.profile.dofs)
    host = mesh2modes(bar, CERAMIC.properties, ex, config=SolverConfig(
        num_modes=12, num_fem_modes=16, tolerance=1e-10, max_mode_freq=96_000.0), mesh=tp)
    out["host"] = (host.summary.eigenvalues, host.modes.freqs)

    # The production render, object-sharded: impacts only, then with voices.
    synth = shard_synth(make_synth([synth_modes()] * 8, sample_rate=48_000.0, device=device),
                        dp)
    strike_all(synth)
    out["impact_mix"] = synth.render(512).cpu().numpy()
    synth = shard_synth(make_synth([synth_modes()] * 8, sample_rate=48_000.0, device=device),
                        dp)
    out["voiced_mix"], out["carries"] = voiced_render(synth)
    out["objects"] = (synth.shard.lo, synth.shard.hi)
    return out


def fail_on_rank(device, bad_rank):
    """Rank `bad_rank` raises while the others wait in a collective for it."""
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    dist.all_reduce(torch.ones(1, device=device))
