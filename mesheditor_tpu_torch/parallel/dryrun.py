"""The multi-device dry run (counterpart of __graft_entry__.py:dryrun_multichip): the
production pipeline over an n-rank mesh on small shapes.

- tp: `mesh2modes` with its elements sharded over the mesh's tp axis. The whole device
  engine (AMG build, ortho-LOBPCG with AMG-PCG inner solves) runs with every element sum
  reduced over the group (small_n=0 keeps the solve off the host path).
- dp: the production `ModalSynth.render` (a strike on every object and a sustained scrape
  voice over a roughness track) with the bank's objects sharded over the dp axis; each
  rank renders its objects through the coupled kernel and the mono mix reduces over dp.

    python -c "from mesheditor_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               dryrun_multichip(2, device='cpu', backend='gloo')"
"""

from __future__ import annotations

import numpy as np

from .._device import resolve_device
from .launch import spawn


def _dryrun_rank(device, n_devices: int) -> dict:
    from .. import SolverConfig, mesh2modes
    from ..api import make_synth
    from ..materials import CERAMIC
    from ..mesh import bar_tets
    from ..synth import ContactTrackSpec, ModalEvent, SustainedVoice, coupled
    from ..synth.tracks import synthesize_roughness
    from .sharding import make_mesh, shard_synth

    mesh = make_mesh(n_devices, device=device)

    bar = bar_tets(0.2, 0.06, 0.05, 6, 3, 3)
    cfg = SolverConfig(num_modes=10, num_fem_modes=14, small_n=0, tolerance=1e-7,
                       max_mode_freq=96_000.0)
    ex = bar.points[:: max(bar.points.shape[0] // 6, 1)][:6]
    result = mesh2modes(bar, CERAMIC.properties, ex, config=cfg, mesh=mesh)
    if result.modes.num_modes == 0 or not np.isfinite(result.modes.freqs).all():
        raise RuntimeError(f"sharded mesh2modes gave {result.modes.num_modes} modes")

    n_obj = max(2 * mesh.shape["dp"], 4)
    synth = shard_synth(make_synth([result] * n_obj, sample_rate=48_000.0, device=device),
                        mesh)
    for o in range(n_obj):
        synth.enqueue(ModalEvent(
            kind="impact", obj=o, expos=o % max(result.modes.shapes.shape[0], 1),
            j=(0.05, 0.02, 0.01), pulse_step=1 / 96.0, pulse_gamma=np.pi / 2 / 96.0,
            accel_amp=0.001))
    slot = synth.adopt_track(7, lambda: synthesize_roughness(1e-4, -2.0, 1e-6))
    synth.publish_voices([SustainedVoice(
        voice_id=1, obj=0, blend_points=(0, 1, 0), blend_weights=(0.5, 0.5, 0.0),
        normal=(0.0, 1.0, 0.0), slip_dir=(1.0, 0.0, 0.0),
        sweep_dir=((1.0, 0.0, 0.0), (0.0, 0.0, -1.0)),
        normal_force=0.6, friction=0.5, stiffness=2e5, static_penetration=3e-6,
        damping_coeff=0.4,
        tracks=tuple(ContactTrackSpec(index=slot, rate=0.4, sigma=2e-7, window=8.0,
                                      step=4e-7) for _ in range(4)),
    )])
    coupled.LAUNCHES = 0
    out = synth.render(256).cpu().numpy()
    if out.shape != (256,) or not np.isfinite(out).all():
        raise RuntimeError(f"sharded render gave {out.shape}, finite {np.isfinite(out).all()}")
    return {
        "mesh": dict(mesh.shape), "f1": float(result.modes.freqs[0]),
        "num_modes": result.modes.num_modes, "dofs": result.profile.dofs,
        "rms": float(np.sqrt((out.astype(np.float64) ** 2).mean())), "out": out,
        "coupled_launches": coupled.LAUNCHES,
    }


def dryrun_multichip(n_devices: int, device="cuda", backend: str | None = None) -> list:
    """Run the dry run on `n_devices` ranks of `device` and print its summary line (rank
    0's). `backend` defaults to the device's own: NCCL on cards (a card per rank), gloo on
    the CPU. Returns every rank's summary dict, in rank order."""
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    results = spawn(_dryrun_rank, n_devices, device=device, backend=backend,
                    args=(n_devices,))
    r0 = results[0]
    print(f"dryrun_multichip ok: mesh {r0['mesh']}, mesh2modes sharded solve "
          f"f1={r0['f1']:.1f} Hz ({r0['num_modes']} modes, {r0['dofs']} dofs), "
          f"render_block voices+tracks rms={r0['rms']:.3e}", flush=True)
    return results
