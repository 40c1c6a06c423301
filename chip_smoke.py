#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mesheditor_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path at full size — the 9,720-tet box solved to 256 modes
(44,289 dofs) and a 1 s, 64-object impact render at 48 kHz — after building the CUDA
kernel from csrc/ and checking it against its plain PyTorch version on the card.
Phases, in order (any failure exits non-zero before the final line):

  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc build (or cached load) of the kernel library;
  3. kernel vs plain: impact_resonator against the plain recurrence on three inputs
     (output < 2e-5 x peak, state rtol 1e-4 / atol 1e-9, impact active/age equal,
     2xS bit-equal to S then S) and both times;
  4. golden render: the fixed synthetic 8-object bank, RMS inside (8.82e-3, 9.10e-3);
  5. main path, solve: mesh2modes on the box (warm-up, then timed): 44,289 dofs, 250
     modes, f1 within 1e-4 of 5103.1 Hz, answered on the device, lowest 20 elastic modes
     within 1e-5 (frequency) of scipy's shift-invert on the same assembled pencil;
  6. main path, render: make_synth over 64 objects, one strike each, 1 s: finite,
     nonzero, and every fused call through the kernel;
  7. timings.

The line before the last is the card's name and power limit; before it, one JSON line
with the kernel's launches, parity and times. The last line is {"ok": true, ...}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
F1_HZ = 5103.1  # the bench box's first elastic mode (reference runs: 5103.037, 5103.115)
GOLDEN_BAND = (8.82e-3, 9.10e-3)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def median_ms(fn, sync, reps: int = 10) -> float:
    fn()  # warm-up
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# ---- scenes for the kernel check (numpy, seeded) ----


def _impact_fields(obj, expos, j, step, age, accel):
    n = len(obj)
    return {
        "active": np.ones(n, bool), "obj": np.asarray(obj, np.int32),
        "expos": np.asarray(expos, np.int32), "j": np.asarray(j, np.float32),
        "pulse_step": np.full(n, step, np.float32),
        "gamma": np.full(n, np.pi / 2 * step, np.float32),
        "accel_amp": np.asarray(accel, np.float32), "age": np.asarray(age, np.int32),
        "total": np.full(n, int(np.ceil(1.0 / step)), np.int32),
    }


def scene_bench(rng, n_obj=64, k=256, per_obj=(1,) * 64):
    """A (64, 256) bank like the bench's, with per_obj[o] impacts on object o."""
    freqs = np.linspace(120.0, 20000.0, k)
    t60 = np.linspace(2.0, 0.1, k)
    from mesheditor_tpu_torch.synth.bank import tune_coeffs

    cr, ci, ds = tune_coeffs(freqs, t60, 48000.0)
    bank = {
        "coeff_re": np.tile(cr, (n_obj, 1)), "coeff_im": np.tile(ci, (n_obj, 1)),
        "disp_scale": np.tile(ds, (n_obj, 1)),
        "shapes": (rng.standard_normal((n_obj, 10, k, 3)) * 0.01).astype(np.float32),
        "out_gain": np.full(n_obj, 0.5 / k * 1e3, np.float32), "sample_rate": 48000.0,
        "z_re": np.zeros((n_obj, k), np.float32), "z_im": np.zeros((n_obj, k), np.float32),
    }
    obj = np.repeat(np.arange(n_obj), per_obj)
    n = obj.size
    imp = _impact_fields(obj, np.arange(n) % 10, rng.standard_normal((n, 3)) * 0.05,
                         1.0 / 150.0, (np.arange(n) * 7) % 40, rng.uniform(0, 1e-3, n))
    return bank, imp


def scene_small(rng_seed=3, n_obj=4, k=32, n_imp=8, impacts_per_obj=2):
    """tests/test_pallas_impact.py:make_scene, rebuilt in numpy."""
    rng = np.random.default_rng(rng_seed)
    freqs = np.linspace(80, 4000, k)
    decay = np.power(1e-3, 1.0 / (0.4 * 48000.0))
    omega = 2 * np.pi * freqs / 48000.0
    bank = {
        "coeff_re": np.tile(decay * np.cos(omega), (n_obj, 1)),
        "coeff_im": np.tile(decay * np.sin(omega), (n_obj, 1)),
        "disp_scale": np.tile(1 / (2 * np.pi * freqs), (n_obj, 1)),
        "shapes": rng.standard_normal((n_obj, 2, k, 3)) * 0.01,
        "out_gain": rng.uniform(0.5, 1.5, n_obj), "sample_rate": 48000.0,
        "z_re": rng.standard_normal((n_obj, k)) * 1e-3,
        "z_im": rng.standard_normal((n_obj, k)) * 1e-3,
    }
    act = np.zeros(n_imp, bool)
    obj = np.zeros(n_imp, np.int32)
    count = 0
    for o in range(n_obj):
        for _ in range(impacts_per_obj):
            if count < n_imp:
                act[count] = True
                obj[count] = o
                count += 1
    imp = {
        "active": act, "obj": obj, "expos": np.arange(n_imp, dtype=np.int32) % 2,
        "j": rng.standard_normal((n_imp, 3)) * 0.05,
        "pulse_step": np.full(n_imp, 1 / 180.0), "gamma": np.full(n_imp, np.pi / 2 / 180.0),
        "accel_amp": rng.uniform(0, 0.01, n_imp),
        "age": np.arange(n_imp, dtype=np.int32) * 3, "total": np.full(n_imp, 180, np.int32),
    }
    return bank, imp


def check_kernel(name, bank, imp, n_samples, n_slots, timed=False):
    """Kernel (CUDA) against the plain version: the full block on the card against the
    same block on host copies, block-boundary invariance on the card, and (timed) both
    recurrences on the same card tensors. Returns the stats dict."""
    import torch

    from mesheditor_tpu_torch import convert
    from mesheditor_tpu_torch.synth import impact
    from mesheditor_tpu_torch.synth.render import _impact_force_curves, impact_gain_rows

    def make(device):
        params, state = convert.bank(**bank, device=device)
        return params, state, convert.impact_table(device=device, **imp)

    pc, sc, ic = make("cuda")
    ph, sh, ih = make("cpu")
    s_k, i_k, out_k = impact.render_block_impacts(pc, sc, ic, n_samples, 1.0, n_slots)
    torch.cuda.synchronize()
    s_p, i_p, out_p = impact.render_block_impacts(ph, sh, ih, n_samples, 1.0, n_slots)
    out_k, out_p = out_k.cpu().numpy(), out_p.numpy()
    peak = max(float(np.abs(out_p).max()), 1e-30)
    err = float(np.abs(out_k - out_p).max())
    assert err < 2e-5 * peak, f"{name}: output error {err:.3e} >= 2e-5 x peak {peak:.3e}"
    for a, b in ((s_k.z_re, s_p.z_re), (s_k.z_im, s_p.z_im)):
        assert np.allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-9), f"{name}: state"
    assert torch.equal(i_k.active.cpu(), i_p.active), f"{name}: impact active"
    assert torch.equal(i_k.age.cpu(), i_p.age), f"{name}: impact age"
    # Block-boundary invariance on the card: 2S samples == S then S, bit for bit.
    s1, i1, o1 = impact.render_block_impacts(pc, sc, ic, n_samples, 1.0, n_slots)
    s2, _i2, o2 = impact.render_block_impacts(pc, s1, i1, n_samples, 1.0, n_slots)
    s12, _i12, o12 = impact.render_block_impacts(pc, sc, ic, 2 * n_samples, 1.0, n_slots)
    assert torch.equal(o12, torch.cat([o1, o2])), f"{name}: 2S != S+S (output)"
    assert torch.equal(s12.z_re, s2.z_re) and torch.equal(s12.z_im, s2.z_im), \
        f"{name}: 2S != S+S (state)"
    stats = {"max_abs_err": err, "rel_err": err / peak}
    if timed:
        force, _prev = _impact_force_curves(ic, n_samples)
        gain_rok, force_sro = impact._regroup(ic, impact_gain_rows(pc, ic), force,
                                              pc.coeff_re.shape[0], n_slots)
        args = (pc.coeff_re, pc.coeff_im, pc.out_gain, gain_rok, force_sro, sc.z_re, sc.z_im)
        mix_k, *_ = impact.resonate(*args)
        mix_p, *_ = impact._resonate_plain(*args)
        stats["max_abs_err"] = float((mix_k - mix_p).abs().max())
        stats["ms"] = median_ms(lambda: impact.resonate(*args), torch.cuda.synchronize)
        stats["plain_ms"] = median_ms(lambda: impact._resonate_plain(*args),
                                      torch.cuda.synchronize)
    log(f"[kernel] {name}: S={n_samples} R={n_slots} " + json.dumps(stats))
    return stats


def golden_rms(device) -> float:
    """bench.py's golden render, rebuilt on the port."""
    from mesheditor_tpu_torch.api import make_synth
    from mesheditor_tpu_torch.synth import ModalEvent
    from mesheditor_tpu_torch.types import ModalModes

    rng = np.random.default_rng(20260820)
    k = 64
    modes = ModalModes(np.linspace(120.0, 9000.0, k), np.linspace(1.2, 0.15, k),
                       (rng.standard_normal((4, k, 3)) * 0.02).astype(np.float32))
    synth = make_synth([modes] * 8, sample_rate=48_000.0, device=device)
    for o in range(8):
        synth.enqueue(ModalEvent(
            kind="impact", obj=o, expos=o % 4, j=(0.04, 0.03, 0.01),
            pulse_step=1.0 / 140.0, pulse_gamma=np.pi / 2 / 140.0, accel_amp=0.0005,
        ))
    out = np.asarray(synth.render_seconds(1.0, 512), np.float64)
    return float(np.sqrt((out ** 2).mean()))


def bench_box(resolution=(18, 10, 9)):
    """The bench's mesh, solver settings and excitation points (bench.py:57-60)."""
    from mesheditor_tpu_torch import SolverConfig
    from mesheditor_tpu_torch.mesh import box_tets

    mesh = box_tets((0.3, 0.16, 0.15), resolution)
    cfg = SolverConfig(num_modes=256, num_fem_modes=256, max_mode_freq=48_000.0,
                       tolerance=1e-6)
    excite = mesh.points[:: max(mesh.points.shape[0] // 10, 1)][:10]
    return mesh, cfg, excite


def host_oracle(mesh, n_eig: int, sigma: float) -> np.ndarray:
    """Lowest n_eig eigenvalues of the port's own assembled pencil by scipy shift-invert
    Lanczos on the host (independent of the device engine)."""
    import scipy.sparse.linalg as spla

    from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                          filter_degenerate)
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.solve.lobpcg import _pencil_csr

    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, CERAMIC.properties, quad, device="cpu")
    k, m = _pencil_csr(ops)
    vals = spla.eigsh(k, k=n_eig, M=m, sigma=sigma, which="LM", return_eigenvectors=False)
    return np.sort(vals)


def render_main(result, device, n_objects=64):
    """bench.py's build_and_render on the port: 64 objects, one strike each, 1 s."""
    from mesheditor_tpu_torch.api import make_synth
    from mesheditor_tpu_torch.synth import ModalEvent

    synth = make_synth([result] * n_objects, sample_rate=48_000.0, device=device)
    for o in range(n_objects):
        synth.enqueue(ModalEvent(
            kind="impact", obj=o, expos=o % max(result.modes.shapes.shape[0], 1),
            j=(0.05, 0.02, 0.01), pulse_step=1.0 / 150.0,
            pulse_gamma=np.pi / 2 / 150.0, accel_amp=0.001,
        ))
    return synth.render_seconds(1.0, 512)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs a GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "mesheditor_tpu_torch").is_dir():
        print(f"chip_smoke: no mesheditor_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    device = "cuda"

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # 2. build
    from mesheditor_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_kernels()
    log(f"[build] kernel library ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS:.2f} s) at {_build.library_path().relative_to(REPO)}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # 3. kernel vs plain on the card
    from mesheditor_tpu_torch.synth import impact

    rng = np.random.default_rng(20260716)
    bank, imp = scene_bench(rng)
    bench_stats = check_kernel("bench (64x256, 1 impact/object)", bank, imp, 16384, 1,
                               timed=True)
    per_obj = np.where(np.arange(64) % 8 == 0, 4, 1)
    bank, imp = scene_bench(rng, per_obj=per_obj)
    check_kernel("stress (4 impacts on 8 objects, S=1000)", bank, imp, 1000, 4)
    bank, imp = scene_small()
    check_kernel("make_scene", bank, imp, 256, 2)
    log(f"[kernel] impact_resonator {bench_stats['ms']:.3f} ms vs plain "
        f"{bench_stats['plain_ms']:.3f} ms at 64x256, S=16384 ({card})")

    # 4. golden render
    rms = golden_rms(device)
    assert GOLDEN_BAND[0] <= rms <= GOLDEN_BAND[1], f"golden rms {rms:.4e} outside {GOLDEN_BAND}"
    log(f"[golden] render rms {rms:.6e} inside {GOLDEN_BAND}")

    # 5-6. the main path, with every count reset just before it
    from mesheditor_tpu_torch import mesh2modes
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.solve import lobpcg

    mesh, cfg, excite = bench_box()
    impact.LAUNCHES = 0
    lobpcg.DEVICE_SOLVES = lobpcg.HOST_SOLVES = 0

    t0 = time.perf_counter()
    warm = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, device=device)
    log(f"[solve] warm-up {time.perf_counter() - t0:.2f} s: {warm.profile.report()}")
    t0 = time.perf_counter()
    result = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, device=device)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    log(f"[solve] timed {solve_s:.3f} s: {result.profile.report()}")
    f1 = float(result.modes.freqs[0]) if result.modes.num_modes else 0.0
    assert result.profile.dofs == 44_289, f"dofs {result.profile.dofs}"
    assert result.modes.num_modes == 250, f"modes {result.modes.num_modes}"
    assert lobpcg.DEVICE_SOLVES == 2 and lobpcg.HOST_SOLVES == 0, \
        f"device solves {lobpcg.DEVICE_SOLVES}, host solves {lobpcg.HOST_SOLVES}"
    assert abs(f1 - F1_HZ) / F1_HZ < 1e-4, f"f1 {f1:.4f} Hz vs {F1_HZ}"
    log(f"[solve] dofs {result.profile.dofs}, modes {result.modes.num_modes}, "
        f"f1 {f1:.4f} Hz, iterations {result.profile.restarts}, device solves "
        f"{lobpcg.DEVICE_SOLVES}, host solves {lobpcg.HOST_SOLVES}")

    # Independent oracle: host shift-invert on the same assembled pencil.
    t0 = time.perf_counter()
    ref = host_oracle(mesh, 26, -((2 * np.pi * cfg.min_mode_freq) ** 2))
    got = result.summary.eigenvalues[6:26]
    rel_f = np.abs(np.sqrt(got) / np.sqrt(ref[6:26]) - 1.0)
    assert rel_f.max() < 1e-5, f"lowest 20 elastic modes off scipy by {rel_f.max():.3e}"
    log(f"[oracle] scipy eigsh {time.perf_counter() - t0:.1f} s: lowest 20 elastic "
        f"frequencies within {rel_f.max():.3e} relative")


    t0 = time.perf_counter()
    audio = render_main(result, device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = impact.LAUNCHES
    n_calls = -(-48_128 // 16_384)
    assert audio.shape == (48_128,) and np.isfinite(audio).all(), "render not finite"
    assert np.abs(audio).max() > 0, "render silent"
    assert launches == n_calls, f"kernel launches {launches} != fused calls {n_calls}"
    log(f"[render] 64 objects x 1 s: rms {float(np.sqrt((audio ** 2).mean())):.6e}, "
        f"kernel launches {launches}")

    # 7. timings
    log(f"[timing] solve_s {solve_s:.3f} render_s {render_s:.3f} ({card})")
    log(json.dumps({"kernels": [{
        "name": "impact_resonator", "route": "cuda",
        "source": "mesheditor_tpu_torch/csrc/impact_resonator.cu",
        "replaces": "mesheditor_tpu/synth/pallas_impact.py:48",
        "launches": launches, "max_abs_err": bench_stats["max_abs_err"],
        "ms": bench_stats["ms"], "plain_ms": bench_stats["plain_ms"],
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
