#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mesheditor_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels | --scene | --render | --files | --viewer | --multichip |
                           --bench | --debug | --scans | --pencil]

Drives the port's main paths at full size — the 9,720-tet box solved to 256 modes
(44,289 dofs), a 1 s, 64-object impact render at 48 kHz, the same 64 objects rendered
for 1 s in 512-sample blocks with 16 sustained voices from the physics bridge, and the
scene-in / audio-out path (a closed surface meshed and solved, a corpus solved into the
model store, a scene of falling bodies simulated to audio, the command line), the
render layer (corpus goldens, the falling bodies at 960x720 with supersample 2, a
turntable recording, the view and record commands) and the file formats (the falling
scene through glTF and back, simulated from the file, the simulate/view/record/sessions
commands on it, a RealImpact scan compared with its render) and the interactive viewer
(the edit command's repaint, picks, gizmo and strike-to-audio, in process and as a
server), the measurement surface (the `bench` command and the bench tools) and the
scanned-object regime (the mesher's snapshot, thin shells and bars against their oracles,
the RealImpact harness on a scan double) and the debugging surface (render_block's
per-sample traces, the eigensolver's per-iteration trace, diag_cdt_solve) and the
eigensolver's general-pencil form (operator callables, the closure engine) — after
building the CUDA kernels from csrc/ and the tet mesher from native/tetmesher.cpp and
checking each kernel against its plain PyTorch version on the card. Phases, in order (any
failure exits non-zero before the final line):

  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc build (one process per source, in parallel) of the kernel library;
  3. impact kernel vs plain: impact_resonator against the plain recurrence on three
     inputs (output < 2e-5 x peak, state rtol 1e-4 / atol 1e-9, impact active/age equal,
     2xS bit-equal to S then S), the state bit-identical to the plain version's on the same
     card tensors, its device time (CUDA events over back-to-back launches of the bound C
     entry), the wrapper's host-clock time and the plain version's; the strike precompute
     kernel bit-equal to the plain chain at box.impacts' shapes, and the same three times;
  4. golden render: the fixed synthetic 8-object bank, RMS inside (8.82e-3, 9.10e-3);
  5. main path, solve: mesh2modes on the box (warm-up, then timed): 44,289 dofs, 250
     modes, f1 within 1e-4 of 5103.1 Hz, answered on the device, lowest 20 elastic modes
     within 1e-5 (frequency) of scipy's shift-invert on the same assembled pencil (run in
     a process of its own beside phases a and b);
  6. main path, impact render: make_synth over 64 objects, one strike each, 1 s: finite,
     nonzero, and every fused call through the impact kernel;
  a. coupled kernel vs plain: coupled_resonator against the plain recurrence on six
     inputs (the reference's test scene; 64x256 with 16 voices on 12 objects, S=16,384;
     1x200 and 256x200 with 256 voices; the main path's layout, 64x256 with one voice on
     each of objects 0-15, S=512; the same with two more voices on object 0, which sends
     the launch down the block path) at tests/test_pallas_coupled.py's tolerances (output
     < 5e-5 x peak, z_im rtol 1e-3 / atol 1e-6 x peak, relief mean rtol 1e-5, penetration
     rtol 1e-4, voice and impact ages equal), 2xS bit-equal to S then S on inputs 1, 2 and
     the main-path layout, the launch plan (warp or block path) each input takes, one
     wrapper call launching the kernel and its mix sum and nothing else (the voices are
     grouped inside the kernel), and the device time at the main-path layout, at its
     3-voice variant and on input 2 (S=512 and 16,384);
  b. rest silence: a resting contact (k * delta0^(3/2) == N exactly) through the coupled
     kernel for 8 blocks of 512 renders exactly 0.0;
  c. main path, sustained render: the solved box as 64 objects, one strike each, 8
     sliding contacts resolved by the physics bridge into 16 voices, 1 s in 94 blocks of
     512 with a publish before each: every block through the coupled kernel and none
     through the impact kernel, finite, nonzero, every voice aged 48,128 samples, and
     different from the impact-only render of the same scene; the per-block wall against
     the 10.667 ms deadline is printed;
  e. surface: api.solve_surface on the reference bench's production case, the torus
     (0.06, 0.025) meshed by the Delaunay mesher at bbox/24 and solved for 30 modes in
     ceramic: 51,402 dofs, 12 modes, f1 within 1e-4 of 5565.28 Hz (on another mesh, both
     counts are printed), the lowest 10 elastic modes within 1e-5 of scipy's shift-invert on
     the mesh that was built, answered by the native mesher and the device engine; then a
     Poisson-ratio edit solved cold and warm (seeded from ModalWarmStart): the warm solve
     takes no more iterations. The mesher's counters, the stage report and the profile
     tree are printed;
  f. store_batch: batch_solve over a seeded corpus of 7 meshes (boxes, a bar, a torus, an
     iso-surface blob) in several buckets into a temporary store: every model reloads
     under its content hash with the row's modes and f1, a second run solves nothing and
     writes no file, one padded solve equals its unpadded solve within 1e-6 (both are
     timed, in turns);
  g. scene: a plane and 8 falling bodies (plastic balls, wooden blocks) reconciled by
     SceneAudio (8 solves, then all up to date, a density edit rescaled with no solve, a
     fresh SceneAudio loading all 8 from the store) and simulated for 1 s by simulate_scene
     at 48 kHz in blocks of 512: finite, audible, impacts through the impact kernel and
     sliding contacts through the coupled kernel, poses written back; the per-block wall
     and the host time of the physics step, the bridge and the render call are printed;
     then the same scene is run again from the stored models with every block also rendered
     by the plain version on host copies of the block's own arguments (the scene's bank
     shape, slots and voices) and held to the kernels' tolerances; the spread of the
     repeated solves of one request (frequencies, mode-shape signs) is printed and must be
     none: the same frequencies, no mode flipped or turned;
  h. cli: `python -m mesheditor_tpu_torch warmup --set quickstart` (the torus solved and
     rendered: 51,402 dofs), then `solve`, `info` and `render`, as subprocesses, each with
     its wall;
  i. render: the render layer, plain PyTorch on the card (no kernel of its own). Six corpus
     scenes (supersampled, cuboid_flat_pointlight, spotlight_floor, textured_quad,
     torus_wireframe, ibl_spheres), built with the port's components, each within one
     quantization step of its golden in tests/fixtures/render_corpus/ (decoded with zlib)
     apart from contested pixels (a near-tie in depth); the falling scene's 8 bodies
     (23,552 triangles) with a directional, a point and a spot light and an IBL map at
     960x720, supersample 2: every 48th row and each body's center row rendered again on
     the CPU by the port's own chunk step and shader (ids equal apart from contested
     pixels, lit values within 1e-4), picks at the body centers and a box select over the
     view equal on both; rasterize (chunk 8, 64, 256) and shade timed apart (median of 5
     after a warm-up with --render, of 3 in the whole run), the chunk the frame derives
     (half the free memory), each call's peak memory within 15% of the byte model
     raster_peak_bytes, the rasterizer's bound with its formula; a 36-frame turntable of
     icosphere(4) at 480x360 to PNG frames; `view` and `record` as subprocesses;
  j. files: the falling scene with phase g's models exported to .glb (models embedded),
     imported into a fresh store, exported and imported again: the two imports' snapshots
     byte-equal; each import reconciled by SceneAudio with no solve and all 8 models
     loaded, then simulate_scene for 0.5 s: finite, audible, through both kernels, the two
     imports' audio bit-identical; import and export walls; as subprocesses on the .glb,
     `simulate --seconds 0.25 --video` (a wav and PNG frames, no solve), `view
     --debug-physics` (one collider wireframe per body of the world), `record --frames 6`,
     and `sessions restore --out s.project` on a session written through actions ("byte-
     exact", and the project holds the live scene's snapshot); a miniature RealImpact scan
     (icosphere(4) as a 15 cm ellipsoid) solved at bbox/24 and held by compare_scan
     (median under 30 cents, match fraction at least 0.5, the impact kernel launched),
     and solved again at bbox/10 against scipy's shift-invert on that mesh (run in a
     process of its own beside the rest of the phase; lowest 10 elastic modes within
     1e-5);
  k. viewer: the falling scene exported to .glb and opened by ViewerApp at edit's defaults
     (960x600, supersample 1, audio on): the cold frame, the frame after an orbit (median of
     5, rasterize and shade from the profile scopes), a click at the centre of a wooden
     block's projected bounds (selects it), the tinted frame (exactly the block's pick
     mask, from a host copy of the G-buffer, is tinted), a translate drag (the block moves,
     one SetTransform a move), a strike on the block (every surface solved: per entity
     dofs, modes, f1, seconds and the path that answered; 3 impact launches and no
     coupled launch, each block held against the plain version as in phase g; audible;
     the spectrum's peaks within 16 Hz of the block's modes; the session byte-exact on
     replay), a second strike's wall; then `edit --audio --port 0` as a fresh process with
     HOME in a temporary directory: an orbit, a click, strike mode, a strike, /frame (an
     RGB PNG of 960x600), /audio (RIFF/WAVE), /inspect?entity=abc (400), /physics and
     /verify-replay (byte-exact), each timed;
  l. multichip: the multi-device layer over torch.distributed, one process per rank
     (parallel/launch.py:spawn). NCCL asked for more ranks than cards is refused. l1: a
     mesh of every card under NCCL (on a one-card machine one rank, which still makes every
     NCCL call): the bench box solved with mesh= (elements over tp) to 250 modes, f1 within
     1e-4 of 5103.1 Hz, every eigenvalue in tests/test_parallel.py's cluster-aware band of
     phase 5's unsharded solve and equal on every rank; the impact second and the sustained
     second through shard_synth (objects over dp). l2: two ranks sharing cuda:0 under gloo
     (real cross-rank sums): dryrun_multichip(2), then the same solve at tp = 2 with its
     wall and the count and bytes of its all_reduces, and the two renders at dp = 2. Every
     rank launches both kernels (the coupled one in each of the 94 blocks), each render's
     mix is within 2e-5 (impact) and 5e-5 (coupled) x peak of the unsharded card render,
     and the voice table's carries are equal on every rank; the per-block wall is printed;
  m. bench: the measurement surface. m1: `python -m mesheditor_tpu_torch bench` as a fresh
     process (the reference's metric and report keys last on stdout; the detail: 44,289
     dofs, 250 modes, f1 within 1e-4 of 5103.1 Hz, the golden RMS in band, kernel parity
     under phase 3's 2e-5, the torus at 51,402 dofs and f1 within 1e-4 of 5565.28 Hz; 10
     impact launches). m2: render_bench's 21 cases through its main, 64 blocks streamed and
     --fused, the counts set to 0 before each run: every case finite, voice cases once a
     block through the coupled kernel, the others through the impact kernel; the first 2
     blocks of every case held against the plain version (blocks_against_plain) and each
     kernel timed at the widest shapes (1,024 objects; 256 objects x 200 modes; K = 512;
     256 voices on one object). m3: edit_loop_bench; m4: cdt_bench, with the path that
     answered; m5: realimpact_batch --devices 1 (one NCCL rank) over two scans written
     here: its rows and a finite, non-zero sharded mix;
  n. scans: the scanned-object regime. A scan double (`make_realimpact_double`: a
     jittered 5%-wall bowl, its recordings from scipy's shift-invert at bbox/28) is written
     in a process of its own from the start. n1: the port-built mesher's 27 non-iso rows of
     the structural snapshot equal tests/fixtures/tet_corpus_snapshot.txt. n2:
     tests/test_thin_shell_parity.py's 5%-wall bowl, 4 mm plate and 2.5%-wall bowl solved
     on the card at its settings, each within 0.1% of scipy (oracles in processes of their
     own); dofs, iterations, the path that answered (with the engine's exit) and the stage
     walls are printed. n3:
     tests/test_modal_solver.py's slow bars on the card: the 20x4x4 square bar's families
     against the closed forms (longitudinal 1%, torsional 5%, bending 10%), the thin 30x5x1
     bar (longitudinal 1%, bending 5%) and the warm start. n4: `python -m
     mesheditor_tpu_torch.scripts.realimpact_harness` at its defaults on the double, as a
     process: each impact's f0 and partials matched as the JAX package's script gives them
     on this double (mean score 0.325), 30 impact launches (5 strikes of 2 s), the first
     strike's blocks within 2e-5 x peak of the plain version on host copies of their
     arguments, 10 wavs that read back; the solve's dofs, iterations, path and wall and
     the process wall are printed;
  o. debug: the JAX package's debugging surface. o1: the first 3 blocks of 512 of the
     sustained second (phase c's scene) rendered by synth.render_block twice on the same
     arguments: debug=False (the coupled kernel, once a block) and debug=True (the plain
     recurrence with its per-sample traces, on the card; it launches nothing). The debug
     mix, state and tables are held to the kernel route's at phase a's tolerances, the
     traces to their invariants (rm_t's and pen_t's last rows equal rm_out and pen_out bit
     for bit, relief_t equals relief transposed, every entry finite), and phase b's
     resting contact renders exactly 0.0 on both routes; both routes' walls a block are
     printed. o2: the bench box's pencil solved by lobpcg_pencil with the eigensolver's
     trace off and on, free and under torch.use_deterministic_algorithms: one `[ortho]`
     line an iteration, and all four solves bit-identical in eigenvalues and vectors (every
     element sum adds in a fixed order); the trace's cost as a wall delta, and the free
     pair's walls beside the flagged pair's. o3: in phase n, the 2.5%-wall bowl (and with
     --scans the noisy scanned bowl) solved with the trace on: its first and last five
     lines, the settled count where it stopped and the `[ortho exit]` line that names the
     exit (certified, settled, budget or noconv) and the gate's iteration. o4: `python
     -m mesheditor_tpu_torch.scripts.diag_cdt_solve 2` as a process: exit 0, each run
     51,402 dofs, f1 within 1e-4 of 5565.28 Hz, one `[ortho]` line an iteration; each run's
     wall, iterations and f1;
  p. pencil: lobpcg_pencil's callable form. p1: the reference's scripts/check_eigensolver.py
     through the port's (`check`) on the 8x2x2 bar (1,275 dofs) and the 24x4x4 bar (11,907
     dofs), 20 modes, inner 24, tol 1e-8, each with Jacobi CG and with CG on float32 sparse
     copies of the pencil: answered by the closure engine alone, the panels by the op-count
     rule (3 + 50 an iteration + 2 a refresh), every audible frequency within 1e-6 of
     scipy's shift-invert, the engine's own six rigid eigenvalues (not exact zeros) under
     1e-6 of the first elastic one; iterations, panels, error, rigid values and walls are
     printed. p2: tests/test_amg.py's routing call (lambdas over op_state=ElementOperators
     with kmat_pc/mmat_pc and the AMG, small_n=0) on the bench box's pencil: eigenvalues and
     vectors bit-identical to the element form's on the card. p3, a record: the 2.5%-wall
     bowl (and with --scans the noisy scanned bowl) through the closure engine (Jacobi, inner
     24, tol 1e-8, 200 iterations at most) with its `[eig]` trace: iterations, the settled
     count and the blocker's rel on the first and last lines, the answer or "empty", the
     answer against phase n's scipy oracle where it has one, and the wall; an empty answer
     after the whole budget passes, a NaN in the trace or a run past its budget fails;
  d. timings and the whole script's wall.

Every eigensolve of phases m, n, o and g (and the main path's warm-up) prints one `solve:`
line as it returns (solve_log): its dofs, the exit that answered (the engine's certified,
settled or budget, or host), its iterations, the iteration at which the engine's gate
opened (where the reference's f32 stage would hand over to its f64 polish) and its wall.
The solves of m1, n4 and o4 run in processes of their own and report through standard
error.

The line before the last is the card's name and power limit; before it, one JSON line
with each kernel's main-path launches, its launches in phases g, j, k, l, m, n and o (o1's
kernel route), parity, times and bound (and its times at render_bench's widest shapes).
The last line is {"ok": true, ...}.

--kernels runs phases 1-3 and a only (the kernels against their plain versions, and their
times) and ends with "kernels: ok" instead. --scene runs phases 1-2 and e-h only and ends
with "scene: ok". --render runs phases 1 and i only and ends with "render: ok". --files
runs phases 1-2 and j only (solving the falling scene into a temporary store first) and
ends with "files: ok". --viewer runs phases 1-2 and k only and ends with "viewer: ok".
--multichip runs phases 1-2 and l only (solving the box unsharded first) and ends with
"multichip: ok". --bench runs phases 1-2 and m only and ends with "bench: ok". --debug
runs phases 1-2 and o1, o2 and o4 only (solving the box first) and ends with "debug: ok".
--scans
runs phases 1-2 and n only, with the ellipsoid shell and the noisy scanned bowl (the JAX
file's other slow shells) solved after n4, after p3 on both thin walls (no oracle), and
ends with "scans: ok" (the noisy bowl's 0 modes fail phase n's bar today). --pencil runs
phases 1-2 and p only (p3 without an oracle) and ends with "pencil: ok".
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict, fields, is_dataclass, replace
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
F1_HZ = 5103.1  # the bench box's first elastic mode (reference runs: 5103.037, 5103.115)
TORUS_DOFS, TORUS_MODES, TORUS_F1_HZ = 51_402, 12, 5565.28  # the reference bench's CDT case
BLOCK_DEADLINE_MS = 512 / 48_000.0 * 1e3


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, sync, reps: int = 10) -> float:
    """Median host-clock time of fn() followed by sync(), after one warm-up call."""
    fn()  # warm-up
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def event_ms(launch, n: int = 100, warmup: int = 5) -> float:
    """Device time of one launch: CUDA events around n back-to-back launches of a bound
    kernel entry (inputs already prepared), after a warm-up, divided by n."""
    import torch

    for _ in range(warmup):
        launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas -v report: name, registers, stack
    frame and spills."""
    import re

    lines, name, frame = [], None, ""
    for line in build_log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
        elif "stack frame" in line:
            frame = line.strip()
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            lines.append(f"{name}: {m.group(1)} registers; {frame}")
            name = None
    return lines


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


def impact_parity(name, kernel, plain, state_atol=1e-9) -> tuple[float, float]:
    """Hold one impact block rendered on the card, (state, impacts, out), to the same block
    from the plain version on host copies of its inputs. Returns (max |error|, peak)."""
    import torch

    (s_k, i_k, out_k), (s_p, i_p, out_p) = kernel, plain
    out_k, out_p = out_k.cpu().numpy(), out_p.numpy()
    peak = max(float(np.abs(out_p).max()), 1e-30)
    err = float(np.abs(out_k - out_p).max())
    assert np.isfinite(out_k).all(), f"{name}: output not finite"
    assert err < 2e-5 * peak, f"{name}: output error {err:.3e} >= 2e-5 x peak {peak:.3e}"
    for a, b in ((s_k.z_re, s_p.z_re), (s_k.z_im, s_p.z_im)):
        assert np.allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=state_atol), \
            f"{name}: state"
    assert torch.equal(i_k.active.cpu(), i_p.active), f"{name}: impact active"
    assert torch.equal(i_k.age.cpu(), i_p.age), f"{name}: impact age"
    return err, peak


def check_kernel(name, bank, imp, n_samples, n_slots, timed=False):
    """Kernel (CUDA) against the plain version: the full block on the card against the
    same block on host copies, block-boundary invariance on the card, and (timed) both
    recurrences on the same card tensors. Returns the stats dict."""
    import torch

    from mesheditor_tpu_torch import convert
    from mesheditor_tpu_torch.synth import impact, strikes
    from mesheditor_tpu_torch.synth.render import _impact_force_curves, impact_gain_rows

    def make(device):
        params, state = convert.bank(**bank, device=device)
        return params, state, convert.impact_table(device=device, **imp)

    pc, sc, ic = make("cuda")
    ph, sh, ih = make("cpu")
    kernel = impact.render_block_impacts(pc, sc, ic, n_samples, 1.0, n_slots)
    torch.cuda.synchronize()
    err, peak = impact_parity(name, kernel,
                              impact.render_block_impacts(ph, sh, ih, n_samples, 1.0, n_slots))
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
        gain_rok, force_sro = strikes._regroup(ic, impact_gain_rows(pc, ic), force,
                                               pc.coeff_re.shape[0], n_slots)
        args = (pc.coeff_re, pc.coeff_im, pc.out_gain, gain_rok, force_sro, sc.z_re, sc.z_im)
        mix_k, zr_k, zi_k = impact.resonate(*args)
        mix_p, zr_p, zi_p = impact._resonate_plain(*args)
        assert torch.equal(zr_k, zr_p) and torch.equal(zi_k, zi_p), \
            f"{name}: state not bit-identical to the plain version on the card"
        stats["state_bit_identical"] = True
        stats["max_abs_err"] = float((mix_k - mix_p).abs().max())
        stats["ms"] = event_ms(impact._bind(*args)[0])
        stats["wrapper_host_ms"] = median_ms(lambda: impact.resonate(*args),
                                             torch.cuda.synchronize)
        stats["plain_ms"] = median_ms(lambda: impact._resonate_plain(*args),
                                      torch.cuda.synchronize)
    log(f"[kernel] {name}: S={n_samples} R={n_slots} " + json.dumps(stats))
    return stats


def strike_scene_bench(rng, live_objs, capacity=128):
    """box.impacts' strike precompute shapes: scene_bench's 64 x 256 bank with 10 sample
    points and the engine's 128-row impact table, live strikes on `live_objs` (a repeat
    raises R) among retired rows that keep stale values; 0.5-3 ms pulses at 48 kHz."""
    bank, _imp = scene_bench(rng)
    step = (1.0 / rng.integers(24, 145, capacity)).astype(np.float32)
    imp = {
        "active": np.zeros(capacity, bool), "obj": rng.integers(0, 64, capacity),
        "expos": rng.integers(0, 10, capacity), "j": rng.standard_normal((capacity, 3)) * 0.05,
        "pulse_step": step, "gamma": np.pi / 2 * step,
        "accel_amp": rng.uniform(0, 2e-3, capacity), "age": rng.integers(0, 400, capacity),
        "total": np.ceil(1.0 / step.astype(np.float64)).astype(np.int32),
    }
    rows = rng.choice(capacity, len(live_objs), replace=False)
    imp["active"][rows] = True
    imp["obj"][rows] = live_objs
    imp["age"][rows] = [rng.integers(0, t) for t in imp["total"][rows]]
    return bank, imp


def strike_flops_bytes(n_imp, n_live, n_kept, n_obj, n_modes, n_slots, n_samples):
    """Operations and bytes of one strike precompute: per live row and sample two forces
    (3 each, the sine counted as one) and the click step (4); per kept slot and mode the
    gain row (6). Reads the table (41 bytes a row) and the kept shape rows; writes the
    three outputs whole."""
    flops = n_samples * n_live * 10 + n_kept * n_modes * 6
    nbytes = (41 * n_imp + 12 * n_kept * n_modes
              + 4 * (n_samples * n_slots * n_obj + n_slots * n_obj * n_modes + n_samples))
    return float(flops), float(nbytes)


def check_strike_kernel(card, n_samples=512) -> dict:
    """The strike precompute kernel against the plain chain on the same card tensors at
    box.impacts' shapes, bit for bit: one live strike, three with two on one object, three
    on one object, each at R = the live maximum and one less (a row dropped; R = 0 writes
    only the click). At two on one object (R = 2): its device time (CUDA events over
    back-to-back launches of the bound C entry), the wrapper's host-clock time and the
    plain chain's, and its bound. Returns the stats dict."""
    import torch

    from mesheditor_tpu_torch import convert
    from mesheditor_tpu_torch.synth import strikes

    rng = np.random.default_rng(20261018)
    stats = {}
    for live in ((3,), (3, 17, 17), (5, 5, 5)):
        bank, imp = strike_scene_bench(rng, live)
        params, _state = convert.bank(**bank, device="cuda")
        table = convert.impact_table(device="cuda", **imp)
        r = int(np.bincount(live).max())
        for n_slots in (r, r - 1):
            launch, got = strikes._bind(params, table, n_samples, 1.0, n_slots)
            launch()
            want = strikes._plain(params, table, n_samples, 1.0, n_slots)
            for what, g, w in zip(("gain_rok", "force_sro", "click"), got, want):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
                    f"strike_precompute {live} R={n_slots}: {what} differs from the plain chain"
        if live != (3, 17, 17):
            continue
        launch = strikes._bind(params, table, n_samples, 1.0, r)[0]
        stats["ms"] = event_ms(launch)
        stats["wrapper_host_ms"] = median_ms(
            lambda: strikes.strike_precompute(params, table, n_samples, 1.0, r),
            torch.cuda.synchronize)
        stats["plain_ms"] = median_ms(
            lambda: strikes._plain(params, table, n_samples, 1.0, r), torch.cuda.synchronize)
        stats["bound_ms"], stats["bound_by"] = bound(*strike_flops_bytes(
            128, len(live), len(live), 64, 256, r, n_samples))
    log(f"[kernel] strike_precompute: bit-equal to the plain chain at 64x256, 128 rows, "
        f"S={n_samples}; at R=2 " + json.dumps(stats) + f" ({card})")
    return stats


# ---- coupled scenes (numpy, seeded) ----

COUPLED_TOL = {  # tests/test_pallas_coupled.py:66-74
    "out": 5e-5,  # x peak
    "z_im": (1e-3, 1e-6),  # rtol, atol x peak
    "relief_mean": (1e-5, 1e-12),
    "penetration": (1e-4, 1e-12),
}


def voice_rows(objs, normal_force=4.0, active=None):
    """The voice rows of tests/test_pallas_coupled.py:add_voices for voices on `objs`,
    in the packed upload layout: (V, 36) float32 and (V, 10) int32."""
    n = len(objs)
    f32 = np.zeros((n, 36), np.float32)
    i32 = np.zeros((n, 10), np.int32)
    f32[:, 0:3] = [0.5, 0.3, 0.2]
    f32[:, 3:6] = [0, 1, 0]
    f32[:, 6:9] = [1, 0, 0]
    f32[:, 9:15] = [1, 0, 0, 0, 0, -1]
    f32[:, 15] = normal_force
    f32[:, 16] = 0.4  # friction
    f32[:, 17] = 2.0**28  # stiffness
    f32[:, 18] = 2.0**-20  # static penetration
    f32[:, 19] = 0.3  # damping
    f32[:, 20:24] = 0.4  # track rate
    f32[:, 24:28] = 2e-7  # sigma
    f32[:, 28:32] = 6.0  # window
    f32[:, 32:36] = 4e-7  # step
    i32[:, 0] = objs
    i32[:, 1:4] = [0, 1, 2]
    i32[:, 8] = 1
    i32[:, 9] = 1
    if active is not None:
        f32[~active] = 0.0
        i32[~active] = 0
    return f32, i32


def track_rows(rng, slots=2, n=512):
    """A pool whose slot 0 holds a random track: (slots, n) heights and (slots, n+1) sums."""
    heights = np.zeros((slots, n), np.float32)
    sums = np.zeros((slots, n + 1), np.float32)
    heights[0] = rng.standard_normal(n).astype(np.float32)
    np.cumsum(heights[0], out=sums[0, 1:])
    return heights, sums


def coupled_scene_small():
    """Input 1: make_scene(4, 32, 8, 1) plus add_voices(4, 4) (last row inactive)."""
    bank, imp = scene_small(impacts_per_obj=1)
    active = np.arange(4) < 3
    f32, i32 = voice_rows(np.arange(4) % 4, active=active)
    return bank, imp, f32, i32, track_rows(np.random.default_rng(11))


def coupled_scene_bench(rng):
    """Input 2: the slice's shape, 64 x 256, one impact per object, 16 voices on 12 objects
    (objects 0-7 one each, 8-11 two each); loads 0.1-6 N, so the knee fires on some."""
    from mesheditor_tpu_torch.synth.tracks import TRACK_SAMPLES

    bank, imp = scene_bench(rng)
    objs = np.concatenate([np.arange(8), np.repeat(np.arange(8, 12), 2)])
    f32, i32 = voice_rows(objs, normal_force=rng.uniform(0.1, 6.0, objs.size))
    return bank, imp, f32, i32, track_rows(rng, n=TRACK_SAMPLES)


def coupled_scene_main(rng, extra_on_0=0):
    """The sustained main path's layout: 64 x 256, one impact per object, one voice on each
    of objects 0-15 (the bridge's 16 voices, one per body), then extra_on_0 more voices on
    object 0 (a body touching several others)."""
    from mesheditor_tpu_torch.synth.tracks import TRACK_SAMPLES

    bank, imp = scene_bench(rng)
    objs = np.concatenate([np.arange(16), np.zeros(extra_on_0, int)])
    f32, i32 = voice_rows(objs, normal_force=rng.uniform(0.1, 6.0, objs.size))
    return bank, imp, f32, i32, track_rows(rng, n=TRACK_SAMPLES)


def coupled_scene_heavy(rng, n_obj):
    """Inputs 3 and 4: n_obj objects x 200 modes, 256 voices spread round-robin."""
    bank, imp = scene_bench(rng, n_obj=n_obj, k=200, per_obj=(1,) * n_obj)
    f32, i32 = voice_rows(np.arange(256) % n_obj, normal_force=rng.uniform(0.1, 6.0, 256))
    return bank, imp, f32, i32, track_rows(rng, n=4096)


def make_coupled(scene, device):
    import torch

    from mesheditor_tpu_torch import convert
    from mesheditor_tpu_torch.synth.bank import VoiceTable, apply_voice_state

    bank, imp, f32, i32, (heights, sums) = scene
    params, state = convert.bank(**bank, device=device)
    table = convert.impact_table(device=device, **imp)
    voices = apply_voice_state(VoiceTable.empty(len(f32), device),
                               torch.tensor(f32, device=device),
                               torch.tensor(i32, device=device))
    return params, state, table, voices, convert.track_pool(heights, sums, device=device)


def coupled_slots(scene):
    imp = scene[1]
    live = imp["obj"][imp["active"]]
    return int(np.bincount(live).max()) if live.size else 0


def coupled_parity(name, kernel, plain, state_scale=None) -> tuple[float, float]:
    """Hold one coupled block rendered on the card, (state, impacts, voices, out), to the
    same block from the plain version on host copies of its inputs, at COUPLED_TOL (the
    state's absolute tolerance is taken times state_scale, the output's peak if None).
    Returns (max |error|, peak)."""
    import torch

    (s_k, i_k, v_k, o_k), (s_p, i_p, v_p, o_p) = kernel, plain
    o_k, o_p = o_k.cpu().numpy(), o_p.numpy()
    peak = max(float(np.abs(o_p).max()), 1e-30)
    err = float(np.abs(o_k - o_p).max())
    assert np.isfinite(o_k).all(), f"{name}: output not finite"
    assert err < COUPLED_TOL["out"] * peak, f"{name}: output error {err:.3e} vs peak {peak:.3e}"
    rtol, atol = COUPLED_TOL["z_im"]
    assert np.allclose(s_k.z_im.cpu().numpy(), s_p.z_im.numpy(), rtol=rtol,
                       atol=atol * (peak if state_scale is None else state_scale)), \
        f"{name}: z_im"
    for field in ("relief_mean", "penetration"):
        rtol, atol = COUPLED_TOL[field]
        a, b = getattr(v_k, field).cpu().numpy(), getattr(v_p, field).numpy()
        assert np.allclose(a, b, rtol=rtol, atol=atol), \
            f"{name}: {field} off by {np.abs(a - b).max():.3e}"
    assert torch.equal(v_k.age.cpu(), v_p.age), f"{name}: voice age"
    assert torch.equal(i_k.active.cpu(), i_p.active), f"{name}: impact active"
    assert torch.equal(i_k.age.cpu(), i_p.age), f"{name}: impact age"
    return err, peak


def check_coupled(name, scene, n_samples, invariance=False):
    """Coupled kernel (CUDA) against the plain version on host copies of the same inputs,
    at the reference's tolerances, and 2S == S then S on the card. Returns the stats."""
    import torch

    from mesheditor_tpu_torch.synth import coupled

    r = coupled_slots(scene)
    before = coupled.LAUNCHES
    kernel = coupled.render_block_coupled(*make_coupled(scene, "cuda"), n_samples, 1.0, 1.0,
                                          1.0, r)
    torch.cuda.synchronize()
    assert coupled.LAUNCHES == before + 1, f"{name}: kernel not launched"
    err, peak = coupled_parity(name, kernel, coupled.render_block_coupled(
        *make_coupled(scene, "cpu"), n_samples, 1.0, 1.0, 1.0, r))
    stats = {"max_abs_err": err, "rel_err": err / peak, "peak": peak}
    if invariance:
        sc = make_coupled(scene, "cuda")
        s1, i1, v1, o1 = coupled.render_block_coupled(*sc, n_samples, 1.0, 1.0, 1.0, r)
        s2, _i2, v2, o2 = coupled.render_block_coupled(sc[0], s1, i1, v1, sc[4], n_samples,
                                                       1.0, 1.0, 1.0, r)
        s12, _i12, v12, o12 = coupled.render_block_coupled(*sc, 2 * n_samples, 1.0, 1.0, 1.0,
                                                           r)
        assert torch.equal(o12, torch.cat([o1, o2])), f"{name}: 2S != S+S (output)"
        assert torch.equal(s12.z_re, s2.z_re) and torch.equal(s12.z_im, s2.z_im), \
            f"{name}: 2S != S+S (state)"
        assert torch.equal(v12.relief_mean, v2.relief_mean) and torch.equal(
            v12.penetration, v2.penetration), f"{name}: 2S != S+S (carries)"
        stats["two_s_bit_equal"] = True
    v_obj = scene[3][:, 0][scene[2][:, 15] > 0]  # live rows (active voices carry a load)
    per_obj = int(np.bincount(v_obj).max()) if v_obj.size else 0
    stats["plan"] = coupled.coupled_plan(scene[0]["coeff_re"].shape[1], r, per_obj)
    log(f"[coupled] {name}: S={n_samples} R={r} " + json.dumps(stats))
    return stats


def time_coupled(scene, n_samples, plain_reps=3):
    """The coupled kernel on the card at one sample count: its device time (CUDA events over
    back-to-back launches of the bound C entry), the wrapper's host-clock time (argument
    checks, allocation, launch, sync), the plain version's host-clock time on the same card
    tensors (None when plain_reps is 0), max |kernel - plain| of the mix and the bound."""
    import torch

    from mesheditor_tpu_torch.synth import coupled

    sc = make_coupled(scene, "cuda")
    args, _vb, _click = coupled.coupled_inputs(*sc, n_samples, 1.0, 1.0, 1.0,
                                               coupled_slots(scene))
    mix_k = coupled.resonate_coupled(*args)[0]
    order, offsets = coupled._group_voices(args[12], sc[0].coeff_re.shape[0], args[13])
    mix_p = coupled._resonate_coupled_plain(*args[:13], order, offsets)[0]
    out = {"max_abs_err": float((mix_k - mix_p).abs().max()),
           "ms": event_ms(coupled._bind(*args)[0]),
           "wrapper_host_ms": median_ms(lambda: coupled.resonate_coupled(*args),
                                        torch.cuda.synchronize),
           "plain_ms": None}
    if plain_reps:
        out["plain_ms"] = median_ms(
            lambda: coupled._resonate_coupled_plain(*args[:13], order, offsets),
            torch.cuda.synchronize, reps=plain_reps)
    out["bound_ms"], out["bound_by"] = bound(*coupled_flops_bytes(args, n_samples))
    return out


def coupled_call_kernels(scene, n_samples=512) -> list[str]:
    """The device kernels one resonate_coupled call launches (torch.profiler), by kind."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mesheditor_tpu_torch.profile import ranged
    from mesheditor_tpu_torch.synth import coupled

    sc = make_coupled(scene, "cuda")
    args, _vb, _click = coupled.coupled_inputs(*sc, n_samples, 1.0, 1.0, 1.0,
                                               coupled_slots(scene))
    coupled.resonate_coupled(*args)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        coupled.resonate_coupled(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not ranged(e.name) and not e.name.startswith(("Memcpy", "Memset"))]
    return ["mix" if "mix_kernel" in n else "coupled" if "coupled" in n else n for n in names]


def rest_modes_and_track():
    """tests/test_render_properties.py's make_modes(64, 0.2) and make_track, in numpy."""
    from mesheditor_tpu_torch.synth.tracks import TRACK_SAMPLES, RoughnessTrack
    from mesheditor_tpu_torch.types import ModalModes

    k, points = 64, 4
    freqs = 40.0 * np.arange(1, k + 1) * 1.031
    t60s = 0.2 / np.arange(1, k + 1)
    shapes = np.zeros((points, k, 3), np.float32)
    for p in range(points):
        a = np.arange(1, k + 1) * 0.37 + p
        shapes[p, :, 0] = np.sin(a) * 0.01
        shapes[p, :, 1] = np.cos(a * 1.7) * 0.01
        shapes[p, :, 2] = np.sin(a * 2.3) * 0.01
    positions = np.stack([np.arange(points) * 0.01, np.zeros(points), np.zeros(points)], -1)
    modes = ModalModes(freqs=freqs, t60s=t60s, shapes=shapes, positions=positions)
    rng = np.random.default_rng(0x9E3779B9)
    h = (rng.random(TRACK_SAMPLES, dtype=np.float64) * 2 - 1).astype(np.float32)
    sums = np.zeros(TRACK_SAMPLES + 1, np.float32)
    np.cumsum(h, out=sums[1:])
    return modes, RoughnessTrack(heights=h, sums=sums, spacing=1e-6, rms=1.0)


def rest_silence(device, blocks=8, frames=512) -> float:
    """A contact at rest (no travel, no slip, k * delta0^(3/2) == N exactly with powers of
    two) rendered through the coupled path: the peak must be exactly 0.0."""
    import torch

    from mesheditor_tpu_torch.synth import ContactTrackSpec, ModalSynth, SustainedVoice

    modes, track = rest_modes_and_track()
    synth = ModalSynth([modes], gains=[1.0], device=device)
    slot = synth.adopt_track(1, lambda: track)
    resting = [SustainedVoice(
        voice_id=1, obj=0, blend_points=(0, 1, 0), blend_weights=(0.5, 0.5, 0.0),
        normal=(0.0, 1.0, 0.0), normal_force=2.0**4, friction=0.5, stiffness=2.0**31,
        static_penetration=2.0**-18, damping_coeff=0.4,
        tracks=tuple(ContactTrackSpec(index=slot, rate=0.0, sigma=2e-7, window=8.0, step=0.0)
                     for _ in range(4)),
    )]
    peak = 0.0
    for _ in range(blocks):
        synth.publish_voices(resting)
        peak = max(peak, float(synth.render(frames).abs().max()))
    torch.cuda.synchronize()
    return peak


def sustained_scene(result, device, seed=20261016, n_objects=64, strikes=True, mesh=None):
    """The sustained main path's scene: 64 instances of the solved box, one strike each, and
    8 sliding contacts between objects (0,1), (2,3), ..., (14,15) resolved by the physics
    bridge into 16 voices; the synth object-sharded over `mesh`'s dp axis when one is given.
    Returns (synth, voices)."""
    from mesheditor_tpu_torch.api import contact_dynamics_for, make_synth
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.physics import AudioContactBridge, SustainedContact
    from mesheditor_tpu_torch.physics.bridge import (SURFACE_MACHINED, SURFACE_SANDBLASTED,
                                                     AudioBody)
    from mesheditor_tpu_torch.synth import ModalEvent

    synth = make_synth([result] * n_objects, sample_rate=48_000.0, device=device)
    if mesh is not None:
        from mesheditor_tpu_torch.parallel import shard_synth

        synth = shard_synth(synth, mesh)
    if strikes:
        for o in range(n_objects):
            synth.enqueue(ModalEvent(
                kind="impact", obj=o, expos=o % max(result.modes.shapes.shape[0], 1),
                j=(0.05, 0.02, 0.01), pulse_step=1.0 / 150.0,
                pulse_gamma=np.pi / 2 / 150.0, accel_amp=0.001,
            ))
    bridge = AudioContactBridge(synth)
    dyn = contact_dynamics_for(result)
    positions = np.asarray(result.modes.positions, np.float64)
    for o in range(n_objects):
        bridge.register(o, AudioBody(o, dyn, CERAMIC.properties, positions,
                                     SURFACE_MACHINED if o % 2 == 0 else SURFACE_SANDBLASTED))
    rng = np.random.default_rng(seed)
    contacts = {}
    for c in range(8):
        normal = np.array([0.0, 1.0, 0.0]) + rng.normal(0.0, 0.1, 3)
        contacts[c] = SustainedContact(
            contact_id=c, body_a=2 * c, body_b=2 * c + 1,
            point=positions[rng.integers(len(positions))], normal=normal / np.linalg.norm(normal),
            normal_force=float(rng.uniform(2.0, 10.0)), slip_speed=float(rng.uniform(0.05, 0.5)),
            sweep_speed_a=float(rng.uniform(0.05, 0.5)),
            sweep_speed_b=float(rng.uniform(0.05, 0.5)), friction=0.4, restitution=0.5,
        )
    return synth, bridge.resolve_voices(contacts, synth.sample_rate)


def sustained_render(synth, voices, blocks=94, frames=512):
    """A frame loop: publish the voice set, render one block, bring it to the host.
    Returns (audio, per-block wall times in ms)."""
    import torch

    out, walls = [], []
    torch.cuda.synchronize()
    for _ in range(blocks):
        t0 = time.perf_counter()
        synth.publish_voices(voices)
        out.append(synth.render(frames).cpu().numpy())
        walls.append((time.perf_counter() - t0) * 1e3)
    return np.concatenate(out), walls


def device_profile(run) -> tuple[float, dict]:
    """torch.profiler (CPU and CUDA activities) around run(), which ends in a sync: the
    host wall in microseconds and {device operation name: [count, microseconds]}. The
    program's spans, which the profiler also lists on the device timeline, are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mesheditor_tpu_torch.profile import ranged

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not ranged(e.name):
            entry = by_name.setdefault(e.name, [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us()
    return wall_us, by_name


def profile_sustained(result, device, blocks=16) -> dict:
    """torch.profiler over a warm window of the sustained frame loop: the device's busy
    and idle share of the wall, device operations per block, and device time by name."""
    synth, voices = sustained_scene(result, device)
    sustained_render(synth, voices, blocks=4)  # warm-up
    wall_us, by_name = device_profile(lambda: sustained_render(synth, voices, blocks=blocks))
    busy = sum(t for _n, t in by_name.values())
    copies = sum(n for name, (n, _t) in by_name.items() if name.startswith(("Memcpy", "Memset")))
    ops = sum(n for n, _t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {
        "blocks": blocks, "profiled_wall_ms_per_block": wall_us / blocks / 1e3,
        "device_ms_per_block": busy / blocks / 1e3,
        "idle_share": (1.0 - busy / wall_us) if busy else None,
        "kernels_per_block": (ops - copies) / blocks, "copies_per_block": copies / blocks,
        "top": [{"name": name[:60], "count": n, "ms_per_block": t / blocks / 1e3,
                 "share": t / busy} for name, (n, t) in top],
    }


def coupled_flops_bytes(args, n_samples) -> tuple[float, float]:
    """Operations and bytes of one coupled call on these inputs: per sample and mode the
    shared update (7), its impact slots (2 per slot) and the mix (2); per stepped voice and
    mode the deflection read (2) and its drive (6), plus ~24 scalar contact operations."""
    coeff_re, gains4, vx, force_sro, gain_rok, v_obj = (args[0], args[3], args[5], args[6],
                                                         args[7], args[12])
    n_obj, n_modes = coeff_re.shape
    n_slots = gain_rok.shape[0]
    n_voice = gains4.shape[1]
    stepped = int(((v_obj >= 0) & (v_obj < n_obj)).sum())
    flops = n_samples * (n_obj * n_modes * (9 + 2 * n_slots) + stepped * (8 * n_modes + 24))
    words = (4 * n_obj * n_modes + n_obj  # coefficients and state in, state out, out_gain
             + stepped * (4 * n_modes + 6 + 2 + 2)  # gain rows, constants, carries in and out
             + vx.shape[0] * 3 * stepped + force_sro.numel() + gain_rok.numel()
             + n_samples + n_voice + n_obj + 1)  # mix; order and offsets
    return float(flops), float(4 * words)


def impact_flops_bytes(n_obj, n_modes, n_slots, n_samples) -> tuple[float, float]:
    """Operations and bytes of one impact call: per sample and mode the update (7), the
    impact slots (2 per slot) and the mix (2)."""
    flops = n_samples * n_obj * n_modes * (9 + 2 * n_slots)
    words = (4 * n_obj * n_modes + n_obj + n_samples * n_slots * n_obj
             + n_slots * n_obj * n_modes + n_samples)
    return float(flops), float(4 * words)


# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound(flops, nbytes) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * t_ops, "operations") if t_ops >= t_bytes else (1e3 * t_bytes, "bytes")


def host_oracle(mesh, n_eig: int, sigma: float, material=None) -> np.ndarray:
    """Lowest n_eig eigenvalues of the port's own assembled pencil by scipy shift-invert
    Lanczos on the host (independent of the device engine)."""
    import scipy.sparse.linalg as spla

    from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                          filter_degenerate)
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.solve.lobpcg import _pencil_csr

    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, material or CERAMIC.properties, quad,
                                    device="cpu")
    k, m = _pencil_csr(ops)
    vals = spla.eigsh(k, k=n_eig, M=m, sigma=sigma, which="LM", return_eigenvectors=False)
    return np.sort(vals)


def coupled_kernel_phase(card: str) -> dict:
    """Phase a: the coupled kernel against its plain version on six inputs, the plan each
    takes, the kernels one call launches, and the device times. Returns the timings by
    (layout, sample count)."""
    check_coupled("input 1: make_scene + add_voices (4x32, 3 live voices)",
                  coupled_scene_small(), 256, invariance=True)
    rng = np.random.default_rng(20260716)
    scene2 = coupled_scene_bench(rng)
    check_coupled("input 2: 64x256, 16 voices on 12 objects", scene2, 16384, invariance=True)
    check_coupled("input 3: 1x200, 256 voices", coupled_scene_heavy(rng, 1), 512)
    check_coupled("input 4: 256x200, 256 voices", coupled_scene_heavy(rng, 256), 512)
    scene_main = coupled_scene_main(rng)
    main_plan = check_coupled("main-path layout: 64x256, one voice on each of objects 0-15",
                              scene_main, 512, invariance=True)["plan"]
    assert main_plan["path"] == "warp", f"the main-path layout took the {main_plan['path']} path"
    scene_three = coupled_scene_main(rng, extra_on_0=2)
    check_coupled("main-path layout with 3 voices on object 0 (18 voices)", scene_three, 512)
    launches_per_call = coupled_call_kernels(scene_main)
    assert sorted(launches_per_call) == ["coupled", "mix"], \
        f"one coupled call launched {launches_per_call}, not the kernel and its mix sum"
    log(f"[coupled] one resonate_coupled call launches {len(launches_per_call)} kernels "
        f"(the coupled kernel and its mix sum): no voice grouping on the card")
    coupled_t = {}
    for label, scene, n, reps in (("main-path layout", scene_main, 512, 3),
                                  ("main-path layout, 3 voices on object 0", scene_three, 512, 0),
                                  ("input 2", scene2, 512, 3), ("input 2", scene2, 16384, 0)):
        t = coupled_t[label, n] = time_coupled(scene, n, plain_reps=reps)
        log(f"[coupled] {label}, S={n}: device {t['ms']:.4f} ms (events), wrapper "
            f"{t['wrapper_host_ms']:.4f} ms (host clock), plain {t['plain_ms']} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), |kernel - plain| "
            f"{t['max_abs_err']:.3e} ({card})")
    return coupled_t


def surface_phase(device, card: str, tet_resolution: int = 24) -> None:
    """Phase e: solve_surface on the bench's production torus, held to the reference's
    answers and to a host oracle; then the warm path after a Poisson-ratio edit. (A
    rehearsal off the card passes a coarser tet_resolution.)"""
    from mesheditor_tpu_torch import SolveReuse, profile
    from mesheditor_tpu_torch.api import solve_surface
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.mesh import cdt, torus_surface, voxel_tets
    from mesheditor_tpu_torch.solve import lobpcg
    from mesheditor_tpu_torch.solve.orchestration import ModalWarmStart, hash_solve_inputs
    from mesheditor_tpu_torch.types import ModalSolveSettings

    pts, tris = torus_surface(0.06, 0.025)
    h = float((pts.max(axis=0) - pts.min(axis=0)).max()) / tet_resolution
    tet_profile = cdt.TetProfile()
    t0 = time.perf_counter()
    tmesh = cdt.generate_tets_delaunay(pts, tris, lattice_h=h, profile=tet_profile)
    log(f"[surface] mesher alone {time.perf_counter() - t0:.2f} s: {tmesh.points.shape[0]} "
        f"points, {tmesh.tets.shape[0]} tets; " + json.dumps(asdict(tet_profile)))

    settings = ModalSolveSettings(num_modes=30)  # -> SolverConfig(num_modes=30, num_fem_modes=45)
    cdt.NATIVE_MESHES = voxel_tets.VOXEL_MESHES = 0
    lobpcg.DEVICE_SOLVES = lobpcg.HOST_SOLVES = 0
    profile.reset()
    profile.enabled = True
    t0 = time.perf_counter()
    cold = solve_surface(pts, tris, CERAMIC.properties, settings=settings,
                         tet_resolution=tet_resolution, reuse=SolveReuse(keep_basis=True), device=device)
    cold_s = time.perf_counter() - t0
    profile.enabled = False
    log(f"[surface] solve_surface {cold_s:.3f} s ({card}): {cold.profile.report()}")
    log(profile.report())
    assert (cdt.NATIVE_MESHES, voxel_tets.VOXEL_MESHES) == (1, 0), \
        f"native meshes {cdt.NATIVE_MESHES}, voxel meshes {voxel_tets.VOXEL_MESHES}"
    assert (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES) == (1, 0), \
        f"device solves {lobpcg.DEVICE_SOLVES}, host solves {lobpcg.HOST_SOLVES}"
    modes = cold.modes
    f1 = float(modes.freqs[0]) if modes.num_modes else 0.0
    log(f"[surface] dofs {cold.profile.dofs}, modes {modes.num_modes}, f1 {f1:.4f} Hz, "
        f"iterations {cold.profile.restarts}, native meshes {cdt.NATIVE_MESHES}, voxel meshes "
        f"{voxel_tets.VOXEL_MESHES}, device solves {lobpcg.DEVICE_SOLVES}")
    if cold.profile.dofs == TORUS_DOFS:
        assert modes.num_modes == TORUS_MODES, f"modes {modes.num_modes} != {TORUS_MODES}"
        assert abs(f1 - TORUS_F1_HZ) / TORUS_F1_HZ < 1e-4, f"f1 {f1:.4f} Hz vs {TORUS_F1_HZ}"
    else:
        log(f"[surface] this machine's build of the mesher gave another mesh: "
            f"{cold.profile.dofs} dofs against the reference's {TORUS_DOFS}; f1 is held to "
            f"the oracle on the mesh that was built")
    assert modes.num_modes > 0 and np.isfinite(modes.freqs).all()
    t0 = time.perf_counter()
    ref = host_oracle(tmesh, 16, -((2 * np.pi * settings.min_mode_freq) ** 2))
    rel_f = np.abs(np.sqrt(cold.summary.eigenvalues[6:16]) / np.sqrt(ref[6:16]) - 1.0)
    assert rel_f.max() < 1e-5, f"lowest 10 elastic modes off scipy by {rel_f.max():.3e}"
    log(f"[surface] scipy eigsh {time.perf_counter() - t0:.1f} s on the same mesh: lowest 10 "
        f"elastic frequencies within {rel_f.max():.3e} relative")

    # The warm path: the basis goes into the app-wide memo under the input hash; a
    # Poisson-ratio edit keeps the hash, so its re-solve is seeded from the memo.
    key = hash_solve_inputs(pts, tris, np.zeros((0, 3)), (1.0, 1.0, 1.0))
    memo = ModalWarmStart()
    memo.offer(key, cold.basis)
    edited = replace(CERAMIC.properties, poisson_ratio=0.21)
    t0 = time.perf_counter()
    edit_cold = solve_surface(pts, tris, edited, settings=settings,
                              tet_resolution=tet_resolution, device=device)
    edit_cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    edit_warm = solve_surface(pts, tris, edited, settings=settings,
                              tet_resolution=tet_resolution, reuse=SolveReuse(seed_basis=memo.lookup(key)), device=device)
    edit_warm_s = time.perf_counter() - t0
    assert edit_warm.modes.num_modes == edit_cold.modes.num_modes > 0
    drift = float(np.abs(edit_warm.modes.freqs / edit_cold.modes.freqs - 1).max())
    assert drift < 1e-4, f"warm solve off the cold one by {drift:.3e}"
    assert edit_warm.profile.restarts <= edit_cold.profile.restarts, \
        f"warm {edit_warm.profile.restarts} iterations > cold {edit_cold.profile.restarts}"
    assert lobpcg.HOST_SOLVES == 0, f"host solves {lobpcg.HOST_SOLVES}"
    log(f"[surface] Poisson 0.19 -> 0.21: cold {edit_cold.profile.restarts} iterations, "
        f"iterate {edit_cold.profile.iterate:.3f} s, wall {edit_cold_s:.3f} s; warm "
        f"{edit_warm.profile.restarts} iterations, iterate {edit_warm.profile.iterate:.3f} s, "
        f"wall {edit_warm_s:.3f} s; frequencies within {drift:.3e} ({card})")


def corpus(seed=20261016):
    """A seeded corpus for batch_solve: boxes, a bar, the torus and an iso-surface blob, each
    with a material and excitation points drawn from the seed."""
    from mesheditor_tpu_torch.materials import ACOUSTIC_MATERIALS
    from mesheditor_tpu_torch.mesh import bar_tets, box_tets, cdt, torus_surface, voxel_tets
    from mesheditor_tpu_torch.mesh.isosurface import noise_blob_surface
    from mesheditor_tpu_torch.solve.batch import CorpusItem

    def delaunay(surface, resolution):
        pts, tris = surface
        h = float((pts.max(axis=0) - pts.min(axis=0)).max()) / resolution
        return cdt.generate_tets_delaunay(pts, tris, lattice_h=h)

    meshes = {
        "box_wide": box_tets((0.3, 0.16, 0.15), (12, 7, 6)),
        "box_cube": box_tets((0.2, 0.2, 0.2), (8, 8, 8)),
        "box_plate": box_tets((0.25, 0.04, 0.12), (14, 3, 8)),
        "box_small": box_tets((0.1, 0.06, 0.05), (10, 6, 5)),
        "bar": bar_tets(0.3, 0.03, 0.03, 30, 4, 4),
        "torus": delaunay(torus_surface(0.06, 0.025), 16),
        # The Delaunay mesher's recovery cascade on an iso-surface gives a sliver-heavy
        # mesh of 20-30x the surface's points on which the default-tolerance solve does not
        # converge in 100 iterations; the voxel mesher's answer solves in 10.
        "blob": voxel_tets.generate_tets(*noise_blob_surface(seed=3, n=14, scale=0.08),
                                         resolution=14),
    }
    rng = np.random.default_rng(seed)
    items = []
    for name, mesh in meshes.items():
        material = ACOUSTIC_MATERIALS[int(rng.integers(len(ACOUSTIC_MATERIALS)))]
        excite = mesh.points[rng.choice(mesh.points.shape[0], 8, replace=False)]
        items.append(CorpusItem(name, mesh, material.properties, excite))
    return items


def store_batch_phase(device, card: str, items=None) -> None:
    """Phase f: a corpus through batch_solve into a temporary store, reloaded, resumed, and
    one padded solve against its unpadded solve. (A rehearsal off the card passes a part
    of the corpus.)"""
    from mesheditor_tpu_torch import SolverConfig, mesh2modes
    from mesheditor_tpu_torch.io.model_store import load_modal_model, modal_model_key
    from mesheditor_tpu_torch.solve import lobpcg
    from mesheditor_tpu_torch.solve.batch import _round_up, batch_solve, pad_tetmesh

    items = items or corpus()
    cfg = SolverConfig(num_modes=30, num_fem_modes=45, max_mode_freq=48_000.0)
    buckets = dict(point_bucket=512, tet_bucket=2048)
    keys = {(_round_up(i.mesh.points.shape[0], 512), _round_up(i.mesh.tets.shape[0], 2048))
            for i in items}
    assert len(items) >= 6 and len(keys) >= 2, f"{len(items)} items in {len(keys)} buckets"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store:
        lobpcg.DEVICE_SOLVES = lobpcg.HOST_SOLVES = 0
        t0 = time.perf_counter()
        rows = batch_solve(items, store, cfg, device=device, **buckets)
        batch_s = time.perf_counter() - t0
        by_name = {i.name: i for i in items}
        for r in rows:
            mesh = by_name[r.name].mesh
            log(f"[batch] {r.name}: {mesh.points.shape[0]} points, {mesh.tets.shape[0]} tets, "
                f"modes {r.num_modes}, f1 {r.f1_hz:.2f} Hz, {r.iterations} iterations, "
                f"{r.solve_seconds:.3f} s")
            assert r.path is not None and r.num_modes > 0, f"{r.name}: no modes"
            modes, mass = load_modal_model(r.path)
            assert modal_model_key(modes, mass) == r.path.stem, f"{r.name}: reloaded != saved"
            assert modes.num_modes == r.num_modes and float(modes.freqs[0]) == r.f1_hz, r.name
        solves = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
        assert sum(solves) == len(items), f"solves {solves} for {len(items)} items"
        files = sorted(os.listdir(store))
        t0 = time.perf_counter()
        again = batch_solve(items, store, cfg, device=device, **buckets)
        again_s = time.perf_counter() - t0
        assert sorted(os.listdir(store)) == files, "the second run wrote a file"
        assert (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES) == solves, "the second run solved"
        assert [(r.name, r.path, r.num_modes, r.f1_hz) for r in again] == \
            [(r.name, r.path, r.num_modes, r.f1_hz) for r in rows]
        # One padded solve against its unpadded solve (the same device engine both times),
        # and what the padding costs: both solved again in turns, each timed.
        item = by_name["box_wide"]
        stored, _mass = load_modal_model(next(r.path for r in rows if r.name == "box_wide"))
        n_pts, n_tets = item.mesh.points.shape[0], item.mesh.tets.shape[0]
        padded = pad_tetmesh(item.mesh, _round_up(n_pts, 512), _round_up(n_tets, 2048))
        timed = {"unpadded": [], "padded": []}
        for label in ("unpadded", "padded", "padded", "unpadded"):
            t0 = time.perf_counter()
            res = mesh2modes(item.mesh if label == "unpadded" else padded, item.material,
                             item.excite_positions, config=cfg, device=device)
            timed[label].append(time.perf_counter() - t0)
            assert res.modes.num_modes == stored.num_modes, label
            err = float(np.abs(stored.freqs / res.modes.freqs - 1).max())
            if label == "unpadded":
                pad_err = err
                assert pad_err < 1e-6, f"padded solve off the unpadded one by {pad_err:.3e}"
            else:  # the padded pencil solved again: what a rerun without the index would store
                resolve_err = err
    log(f"[batch] box_wide ({n_pts} points, {n_tets} tets; padded to {padded.points.shape[0]}, "
        f"{padded.tets.shape[0]}): unpadded solves {timed['unpadded'][0]:.3f} / "
        f"{timed['unpadded'][1]:.3f} s, padded solves {timed['padded'][0]:.3f} / "
        f"{timed['padded'][1]:.3f} s (order: unpadded, padded, padded, unpadded); the padded "
        f"pencil solved again lies {resolve_err:.3e} from the stored model ({card})")
    log(f"[batch] {len(items)} items in {len(keys)} buckets: {batch_s:.3f} s, device solves "
        f"{solves[0]}, host solves {solves[1]}; second run {again_s:.3f} s, no solve and no "
        f"new file; padded against unpadded frequencies within {pad_err:.3e} ({card})")


def falling_scene(seed=20261016, n_bodies=8):
    """A static plane and n_bodies audible dynamic bodies above it: plastic balls (sphere
    colliders) and wooden blocks (box colliders), thrown sideways so that they strike the
    plane, then slide or roll, then rest. The first ball starts 3 cm above the plane with no
    velocity: it strikes and bounces while the others still fall, so its strike rings in
    blocks with no sustained voice (the impact render), where every later strike lands in a
    block that some sliding body sends through the coupled render. Returns (registry, body
    entities)."""
    from mesheditor_tpu_torch.materials import PLASTIC, WOOD
    from mesheditor_tpu_torch.mesh import grid_box_surface, icosphere_surface
    from mesheditor_tpu_torch.scene import components as c
    from mesheditor_tpu_torch.scene.registry import Registry

    rng = np.random.default_rng(seed)
    reg = Registry()
    floor = reg.create()
    reg.emplace(floor, c.RigidBodyComponent(shape_kind="plane"))
    # Surfaces about as fine as the tet lattice (bbox/24): the Delaunay mesher keeps the
    # surface triangles, and triangles much larger than the lattice give flat boundary
    # tets on which the device eigensolver needs 60-100+ iterations instead of 20-30.
    ball_pts, ball_tris = icosphere_surface(4)
    half = np.array([0.08, 0.02, 0.05])
    block_pts, block_tris = grid_box_surface(8)
    block_pts = (block_pts - 0.5) * 2.0 * half
    bodies = []
    for i in range(n_bodies):
        e = reg.create()
        ball = i % 2 == 0
        material = PLASTIC if ball else WOOD
        p = material.properties
        reg.emplace(e, c.MeshSurface(positions=ball_pts * 0.05 if ball else block_pts,
                                     triangles=ball_tris if ball else block_tris))
        reg.emplace(e, c.AcousticMaterialRef(
            name=material.name, density=p.density, young_modulus=p.young_modulus,
            poisson_ratio=p.poisson_ratio, alpha=p.alpha, beta=p.beta))
        reg.emplace(e, c.SolveSettingsComponent())
        position = np.array([0.35 * i - 1.2, rng.uniform(0.15, 0.35), rng.uniform(-0.3, 0.3)])
        velocity = np.array([rng.uniform(0.8, 2.0), 0.0, rng.uniform(-0.4, 0.4)])
        spin = rng.normal(0.0, 1.0, 3)
        if i == 0:
            position[1], velocity, spin = 0.08, np.zeros(3), np.zeros(3)
        reg.emplace(e, c.Transform(translation=position))
        reg.emplace(e, c.RigidBodyComponent(
            shape_kind="sphere" if ball else "box", radius=0.05, half_extents=half.copy(),
            is_dynamic=True, mass=0.54 if ball else 0.48, linear_velocity=velocity,
            angular_velocity=spin))
        bodies.append(e)
    return reg, bodies


@contextlib.contextmanager
def solve_log(tag: str | None = None, card: str = ""):
    """While open, every lobpcg_pencil call (direct, or through mesh2modes) is logged under
    `tag` as it returns, with its dofs, the exit that answered (the engine's, "host",
    "rigid", or "none" for the empty result), its iterations, the iteration at which the
    engine's gate opened ("-" while closed) and its wall on the host clock, ending in a
    sync. With no `tag` each record goes to standard error as one `[solve] {json}` line
    instead (a process of its own: solve_lines reads them)."""
    import importlib

    import torch

    from mesheditor_tpu_torch.solve import lobpcg

    m2m = importlib.import_module("mesheditor_tpu_torch.solve.mesh2modes")
    inner = lobpcg.lobpcg_pencil

    def wrapper(ops, nev, **kw):
        t0 = time.perf_counter()
        res = inner(ops, nev, **kw)
        if res.eigenvectors.is_cuda:
            torch.cuda.synchronize()
        rec = {"dofs": int(ops.n_dofs), "exit": res.exit or "none",
               "iterations": int(res.iterations), "gate": res.gate,
               "wall_s": time.perf_counter() - t0}
        if tag is None:
            print("[solve] " + json.dumps(rec), file=sys.stderr, flush=True)
        else:
            log_solve(tag, rec, card)
        return res

    lobpcg.lobpcg_pencil = m2m.lobpcg_pencil = wrapper
    try:
        yield
    finally:
        lobpcg.lobpcg_pencil = m2m.lobpcg_pencil = inner


def log_solve(tag: str, rec: dict, card: str) -> None:
    log(f"{tag} solve: {rec['dofs']} dofs, exit {rec['exit']}, {rec['iterations']} "
        f"iterations, gate {rec['gate'] or '-'}, {rec['wall_s']:.3f} s ({card})")


def solve_lines(stderr: str, tag: str, card: str) -> list:
    """The `[solve]` records a process printed under solve_log, each logged under `tag`."""
    records = [json.loads(line.split(" ", 1)[1]) for line in stderr.splitlines()
               if line.startswith("[solve] ")]
    for rec in records:
        log_solve(tag, rec, card)
    return records


# A module run as `python -m` runs it (argv: the repo, the module, its arguments), with its
# solves logged by solve_log to standard error.
SOLVE_LOG_CODE = """
import runpy, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
module = sys.argv[2]
sys.argv = [module] + sys.argv[3:]
with chip_smoke.solve_log():
    runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def _on_host(arg):
    """A host copy of a dataclass of tensors (a bank, a table, the pool); anything else as
    it is."""
    import torch

    if not is_dataclass(arg):
        return arg
    copy = {}
    for f in fields(arg):
        value = getattr(arg, f.name)
        copy[f.name] = value.detach().cpu().clone() if isinstance(value, torch.Tensor) else value
    return type(arg)(**copy)


@contextlib.contextmanager
def blocks_against_plain(limit=None):
    """While open, every block a ModalSynth renders is rendered twice: by the engine's own
    call, and by the same function on host copies of the same arguments, taken before the
    call, where the wrapper runs the kernel's plain version. The two are held to the
    kernels' tolerances (impact_parity, coupled_parity), with the state's absolute
    tolerance taken against the block's largest state value: a scene's modes ring at
    amplitudes far apart. Yields {"impact": {...}, "coupled": {...}}: the blocks checked
    and those of them that sound, the worst error relative to its block's peak, and the
    largest shapes seen. With `limit`, only the first `limit` blocks are checked and the
    rest pass through. The host
    copies launch nothing, so the launch counts are those of the engine's calls."""
    from mesheditor_tpu_torch.synth import coupled, impact

    stats = {kind: {"blocks": 0, "max_abs_err": 0.0, "max_rel_err": 0.0, "bank": None,
                    "slots": 0, "live_impacts": 0, "live_voices": 0, "voices_per_object": 0,
                    "sounding_blocks": 0}
             for kind in ("impact", "coupled")}
    inner = {"impact": impact.render_block_impacts, "coupled": coupled.render_block_coupled}

    def checked(kind):
        def render(*args):
            if limit is not None and sum(st["blocks"] for st in stats.values()) >= limit:
                return inner[kind](*args)
            host = [_on_host(a) for a in args]
            got = inner[kind](*args)
            want = inner[kind](*host)
            st = stats[kind]
            name = f"scene {kind} block {st['blocks']}"
            z_peak = float(max(want[0].z_re.abs().max(), want[0].z_im.abs().max()))
            if kind == "impact":
                err, peak = impact_parity(name, got, want, state_atol=1e-9 + 1e-6 * z_peak)
                st["slots"] = max(st["slots"], args[5])
            else:
                err, peak = coupled_parity(name, got, want, state_scale=max(
                    float(want[3].abs().max()), z_peak))
                st["slots"] = max(st["slots"], args[9])
                st["live_voices"] = max(st["live_voices"], int(host[3].active.sum()))
                st["voices_per_object"] = max(st["voices_per_object"], args[10])
            st["blocks"] += 1
            st["sounding_blocks"] += peak > 1e-30
            st["bank"] = max(st["bank"] or [0, 0], list(args[0].coeff_re.shape),
                             key=lambda shape: shape[0] * shape[1])
            st["live_impacts"] = max(st["live_impacts"], int(host[2].active.sum()))
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if peak > 1e-30:
                st["max_rel_err"] = max(st["max_rel_err"], err / peak)
            return got

        return render

    impact.render_block_impacts = checked("impact")
    coupled.render_block_coupled = checked("coupled")
    try:
        yield stats
    finally:
        impact.render_block_impacts = inner["impact"]
        coupled.render_block_coupled = inner["coupled"]


def solve_spread(models) -> dict:
    """How far repeated solves of one request lie apart, each against the first: the
    largest relative frequency difference, and of the mode shapes at the sample points the
    modes that agree, agree after a sign flip, or do neither (a multiplet's basis turned),
    at 1e-3 of the mode's largest component."""
    first = models[0]
    out = {"modes": int(first.num_modes), "freq_rel": 0.0, "same": 0, "flipped": 0, "turned": 0,
           "f_hz": [round(float(f), 2) for f in first.freqs[:10]]}
    a = np.asarray(first.shapes, np.float64)  # (P, K, 3)
    scale = np.abs(a).max(axis=(0, 2)) + 1e-300
    for other in models[1:]:
        if other.num_modes != first.num_modes:
            out["modes"] = [out["modes"], int(other.num_modes)]
            continue
        out["freq_rel"] = max(out["freq_rel"], float(np.abs(other.freqs / first.freqs - 1).max()))
        b = np.asarray(other.shapes, np.float64)
        same = np.abs(a - b).max(axis=(0, 2)) < 1e-3 * scale
        flipped = ~same & (np.abs(a + b).max(axis=(0, 2)) < 1e-3 * scale)
        out["same"] += int(same.sum())
        out["flipped"] += int(flipped.sum())
        out["turned"] += int((~same & ~flipped).sum())
    return out


def scene_phase(device, card: str, tet_resolution: int = 24, store=None) -> dict:
    """Phase g: SceneAudio's reconcile cycle and simulate_scene on the falling scene, with
    its models solved into `store` (a temporary directory when None). Returns, for each
    kernel, its launches in the simulate_scene run and the parity record of the checked
    second run ("kernels"), and each body's density and ModalModel as the second run had
    them ("bodies"). (A rehearsal off the card passes a coarser tet_resolution.)"""
    import torch

    from mesheditor_tpu_torch import profile
    from mesheditor_tpu_torch.mesh import cdt, voxel_tets
    from mesheditor_tpu_torch.scene import components as c
    from mesheditor_tpu_torch.scene.audio_sync import SceneAudio, simulate_scene
    from mesheditor_tpu_torch.solve import lobpcg
    from mesheditor_tpu_torch.synth import coupled, impact

    reg, bodies = falling_scene()
    start = {e: reg.get(e, c.Transform).translation.copy() for e in bodies}
    with (contextlib.nullcontext(store) if store else
          tempfile.TemporaryDirectory(prefix="chip_smoke_scene_")) as store:
        cdt.NATIVE_MESHES = voxel_tets.VOXEL_MESHES = 0
        lobpcg.DEVICE_SOLVES = lobpcg.HOST_SOLVES = 0
        sa = SceneAudio(reg, store, tet_resolution=tet_resolution, device=device)
        t0 = time.perf_counter()
        with solve_log("[scene]", card):
            first = sa.reconcile()
        reconcile_s = time.perf_counter() - t0
        assert first.solved == bodies, f"solved {first.solved}, not every body once"
        assert lobpcg.DEVICE_SOLVES == len(bodies) and lobpcg.HOST_SOLVES == 0, \
            f"device solves {lobpcg.DEVICE_SOLVES}, host solves {lobpcg.HOST_SOLVES}"
        assert (cdt.NATIVE_MESHES, voxel_tets.VOXEL_MESHES) == (len(bodies), 0), \
            f"native meshes {cdt.NATIVE_MESHES}, voxel meshes {voxel_tets.VOXEL_MESHES}"
        for e in bodies[:2]:
            m = sa._live[e].modes
            log(f"[scene] entity {e} ({reg.get(e, c.AcousticMaterialRef).name}): "
                f"{m.num_modes} modes, f1 {float(m.freqs[0]):.1f} Hz, mass "
                f"{sa._live[e].mass.mass:.3f} kg")
        assert all(sa._live[e].modes.num_modes > 0 for e in bodies), "a body has no modes"
        for kind, same in (("ball", bodies[0::2]), ("block", bodies[1::2])):
            spread = solve_spread([sa._live[e].modes for e in same])
            log(f"[scene] the {len(same)} solves of the one {kind} request: "
                + json.dumps(spread))
            # The element sums add in a fixed order, so a request solved again repeats bit
            # for bit: the same frequencies, and no mode comes back flipped or turned.
            assert spread["freq_rel"] == 0.0 and spread["flipped"] == spread["turned"] == 0, \
                f"the {kind} request's solves do not repeat: {spread}"
        assert sa.reconcile().up_to_date == bodies, "second reconcile not all up to date"
        # A density edit is an exact rescale: no eigensolve.
        reg.get(bodies[0], c.AcousticMaterialRef).density *= 1.1
        f_before = sa._live[bodies[0]].modes.freqs.copy()
        edit = sa.reconcile()
        assert edit.rescaled == [bodies[0]] and not edit.solved, f"density edit: {edit}"
        assert lobpcg.DEVICE_SOLVES == len(bodies) and lobpcg.HOST_SOLVES == 0
        ratio = float(np.median(sa._live[bodies[0]].modes.freqs / f_before))
        assert abs(ratio - 1.1 ** -0.5) < 1e-3, f"rescaled frequencies moved by {ratio}"
        # A fresh coordinator over the same registry and store loads everything.
        fresh = SceneAudio(reg, store, tet_resolution=tet_resolution,
                           device=device).reconcile()
        assert fresh.loaded == bodies and not fresh.solved, f"fresh SceneAudio: {fresh}"
        log(f"[scene] reconcile: {len(bodies)} bodies solved in {reconcile_s:.3f} s (native "
            f"meshes {cdt.NATIVE_MESHES}, voxel meshes 0, device solves {lobpcg.DEVICE_SOLVES}, "
            f"host solves 0); second reconcile all up to date; density edit rescaled (x"
            f"{ratio:.5f}) with no solve; a fresh SceneAudio loaded all {len(bodies)} ({card})")

        impact.LAUNCHES = coupled.LAUNCHES = 0
        profile.reset()
        profile.enabled = True  # the scene's spans: play/physics, play/bridge, play/block
        try:
            t0 = time.perf_counter()
            audio = simulate_scene(reg, store, seconds=1.0, sample_rate=48_000.0,
                                   block_size=512, tet_resolution=tet_resolution, device=device)
            scene_s = time.perf_counter() - t0
        finally:
            profile.enabled = False
        spans = {}
        for span in profile.records():
            spans.setdefault(span.name, []).append((span.start, span.end))
        steps_counted = profile.counts().get("physics/steps", 0)
        profile.reset()
        launches = {"impact": impact.LAUNCHES, "coupled": coupled.LAUNCHES}
        # The same scene again from the stored models (nothing is solved), this time with
        # every block also rendered by the plain version on host copies of its inputs.
        reg2, bodies2 = falling_scene()
        reg2.get(bodies2[0], c.AcousticMaterialRef).density *= 1.1
        for e, e2 in zip(bodies, bodies2):  # a reloaded scene: each body names its model
            reg2.emplace(e2, replace(reg.get(e, c.ModalModel)))
        with blocks_against_plain() as parity:
            t0 = time.perf_counter()
            audio2 = simulate_scene(reg2, store, seconds=1.0, sample_rate=48_000.0,
                                    block_size=512, tet_resolution=tet_resolution,
                                    device=device)
            checked_s = time.perf_counter() - t0
        checked = {k: parity[k]["blocks"] for k in parity}
        assert checked == launches, f"checked blocks {checked} against launches {launches}"
        assert parity["impact"]["live_impacts"] > 0 and parity["impact"]["sounding_blocks"] > 0, \
            "no strike went through the impact render"
        assert parity["coupled"]["live_voices"] > 0 and parity["coupled"]["live_impacts"] > 0
        assert (impact.LAUNCHES, coupled.LAUNCHES) == (2 * launches["impact"],
                                                       2 * launches["coupled"])
        rerun_diff = float(np.abs(audio2 - audio).max())
    assert lobpcg.DEVICE_SOLVES == len(bodies) and lobpcg.HOST_SOLVES == 0, \
        "simulate_scene solved again"
    assert voxel_tets.VOXEL_MESHES == 0 and cdt.NATIVE_MESHES == len(bodies)
    blocks = 94
    assert audio.shape == (blocks * 512,) and np.isfinite(audio).all(), "scene audio not finite"
    assert np.abs(audio).max() > 0, "scene audio silent"
    assert launches["impact"] > 0 and launches["coupled"] > 0, f"kernel launches {launches}"
    assert launches["impact"] + launches["coupled"] == blocks, f"{launches} over {blocks} blocks"
    for e in bodies:
        t = reg.get(e, c.Transform).translation
        assert 0.0 < t[1] < start[e][1], f"entity {e} pose {t}"
        assert e == bodies[0] or t[0] != start[e][0], f"entity {e} did not travel: {t}"
    ends = np.array([end for _t0, end in spans["play/block"]])
    assert ends.size == blocks
    assert len(spans["play/physics"]) == steps_counted > 0, "a physics step went uncounted"
    walls = np.diff(np.concatenate([[spans["play/physics"][0][0]], ends])) * 1e3

    def per_block(name):
        """Host milliseconds of `name` spans inside each block (a block ends with its
        render's `play/block` span)."""
        out = np.zeros(blocks)
        for a, b in spans[name]:
            out[min(int(np.searchsorted(ends, b)), blocks - 1)] += (b - a) * 1e3
        return out

    step, bridge, render = (per_block("play/physics"), per_block("play/bridge"),
                            per_block("play/block"))
    log(f"[scene] plane + {len(bodies)} bodies, 1 s at 48 kHz in {blocks} blocks of 512: rms "
        f"{float(np.sqrt((audio.astype(np.float64) ** 2).mean()))!r} (the second run's "
        f"{float(np.sqrt((audio2.astype(np.float64) ** 2).mean()))!r}; every call of the "
        f"script solves the scene afresh and must print these bits again), peak "
        f"{float(np.abs(audio).max()):.3e}; impact launches {launches['impact']}, coupled "
        f"launches {launches['coupled']} (one kernel launch per block); "
        f"{len(spans['play/physics'])} physics steps")
    log(f"[scene] every block of the same scene, run again from the stored models, against "
        f"the plain version on host copies of its inputs ({checked_s:.3f} s): "
        + json.dumps(parity) + f"; max |second run - first run| {rerun_diff:.3e} ({card})")
    log(f"[scene] per-block wall median {float(np.median(walls)):.3f} ms, largest "
        f"{float(walls.max()):.3f} ms against the {BLOCK_DEADLINE_MS:.3f} ms deadline; host "
        f"per block (median / largest): world.step {float(np.median(step)):.3f} / "
        f"{float(step.max()):.3f} ms, bridge {float(np.median(bridge)):.3f} / "
        f"{float(bridge.max()):.3f} ms, render call {float(np.median(render)):.3f} / "
        f"{float(render.max()):.3f} ms; shares of the loop: world.step "
        f"{float(step.sum() / walls.sum()):.3f}, bridge {float(bridge.sum() / walls.sum()):.3f}, "
        f"render {float(render.sum() / walls.sum()):.3f}; simulate_scene "
        f"{scene_s:.3f} s in all ({card})")
    return {"kernels": {kind: {"launches": launches[kind], **parity[kind]} for kind in launches},
            "bodies": [(reg2.get(e, c.AcousticMaterialRef).density, reg2.get(e, c.ModalModel))
                       for e in bodies2]}


def cli_phase() -> None:
    """Phase h: the command line as subprocesses, on the card (its default device): warmup
    --set quickstart (the builds are there already; the torus solved and rendered), then
    solve, info and render, each with its wall."""
    from mesheditor_tpu_torch.mesh import save_obj, torus_surface

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        obj = Path(tmp) / "torus.obj"
        save_obj(obj, *torus_surface(0.06, 0.025, 24, 12))

        def run(*argv):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "mesheditor_tpu_torch", *argv],
                                  cwd=REPO, capture_output=True, text=True, timeout=600)
            assert proc.returncode == 0, f"{argv[0]} exited {proc.returncode}:\n{proc.stderr}"
            log(f"[cli] {argv[0]} ({time.perf_counter() - t0:.1f} s): "
                + " | ".join(proc.stdout.replace("\r", "\n").strip().splitlines()[-4:]))
            return proc.stdout

        out = run("warmup", "--set", "quickstart")
        assert "warmup done" in out and f"{TORUS_DOFS} dofs" in out, out
        out = run("solve", str(obj), "--material", "Glass", "--modes", "20", "--vertices", "8",
                  "--max-freq", "48000", "--tet-resolution", "14", "--out-dir",
                  str(Path(tmp) / "modal"))
        model = out.rsplit("model -> ", 1)[1].strip()
        assert Path(model).exists(), f"solve named {model}, which is not there"
        assert "modes: 20" in run("info", model)
        wav = Path(tmp) / "torus.wav"
        run("render", model, "--out", str(wav), "--seconds", "1.0")
        assert wav.stat().st_size > 48_000, "render wrote a short wav"


# ---- phase i: the render layer (plain PyTorch on the card; no kernel of its own) ----

GOLDEN_DIR = REPO / "tests" / "fixtures" / "render_corpus"
GOLDEN_SIZE = (240, 160)
RENDER_GOLDENS = ("supersampled", "cuboid_flat_pointlight", "spotlight_floor", "textured_quad",
                  "torus_wireframe", "ibl_spheres")
CONTESTED_SHARE = 5e-4  # of an image's pixels: the port's CPU tests see at most 1.8e-4
# Float operations of one pixel-triangle pair in the rasterizer: 3 edge functions at 2 mul
# + 1 sub each (their per-triangle differences aside), 3 mul by 1/area, 3 compares for
# coverage, the depth (3 mul + 2 add), 2 compares for the depth range, 1 for the z-resolve.
RASTER_FLOPS_PER_PAIR = 23
PEAK_MODEL_RTOL = 0.15  # measured peak memory of a rasterize call against raster_peak_bytes


def contested_pixels(tri_buf, tris, clip, pixels, rtol=1e-4) -> list:
    """For each (y, x) of a triangle-id buffer: whether its winner ties in depth with
    another triangle, that is both cover the pixel center (float64 barycentrics >= -1e-6)
    at float64 depths within rtol of each other. On such a pixel two valid float orders
    of the rasterizer (XLA's fused multiply-adds, PyTorch's rounded products) may pick
    different triangles; on no other pixel may they differ."""
    h, w = tri_buf.shape
    v = np.asarray(clip, np.float64)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    cw = v[:, 3]
    ndc = v[:, :3] / np.where(cw == 0, 1.0, cw)[:, None]
    sx, sy = ((ndc[:, 0] + 1) * 0.5 * w)[tris], ((1 - ndc[:, 1]) * 0.5 * h)[tris]
    nz = ndc[:, 2][tris]
    area = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0])
    usable = (cw[tris] > 1e-6).all(1) & (area != 0)
    area = np.where(usable, area, 1.0)
    a, b = [1, 2, 0], [2, 0, 1]
    out = []
    for y, x in pixels:
        win = int(tri_buf[y, x])
        if win < 0:
            out.append(False)  # background against a triangle is never a tie
            continue
        px, py = x + 0.5, y + 0.5
        e = (sx[:, b] - sx[:, a]) * (py - sy[:, a]) - (sy[:, b] - sy[:, a]) * (px - sx[:, a])
        bary = e / area[:, None]
        cover = usable & (bary >= -1e-6).all(1)
        z = (bary * nz).sum(1)
        rival = cover & (np.abs(z - z[win]) <= rtol * abs(z[win]))
        rival[win] = False
        out.append(bool(cover[win] and rival.any()))
    return out


def golden_check(view, golden) -> tuple[int, int]:
    """(pixels more than one step from the golden, how many of them are contested) for a
    rendered SceneRenderer; a pixel of a supersampled image is contested when one of its
    samples is."""
    img = np.clip(np.round(view.image() * 255.0), 0, 255).astype(np.uint8)
    assert img.shape == golden.shape, (img.shape, golden.shape)
    bad = np.argwhere(np.abs(img.astype(np.int16) - golden.astype(np.int16)).max(-1) > 1)
    ss = max(int(view.settings.supersample), 1)
    tri = view.gbuf.tri.cpu().numpy()
    subs = [(y * ss + i, x * ss + j) for y, x in bad for i in range(ss) for j in range(ss)]
    flags = np.asarray(contested_pixels(tri, view._tris, view.clip, subs), bool)
    return len(bad), int(flags.reshape(len(bad), ss * ss).any(1).sum()) if len(bad) else 0


def corpus_scene(name):
    """One scene of scripts/render_corpus.py built with the port's components (that script
    imports the JAX package): (registry, camera or None, RenderSettings)."""
    from mesheditor_tpu_torch.mesh import (
        cuboid_surface, icosphere_surface, plane_surface, torus_surface,
    )
    from mesheditor_tpu_torch.render import RenderSettings
    from mesheditor_tpu_torch.render.camera import orbit_camera
    from mesheditor_tpu_torch.scene import components as c
    from mesheditor_tpu_torch.scene.derive import install_default_pipeline
    from mesheditor_tpu_torch.scene.registry import Registry

    r = Registry()
    install_default_pipeline(r)

    def add(pts, tris, pos=(0, 0, 0), mat=None):
        e = r.create()
        t = c.Transform(translation=np.asarray(pos, np.float64))
        t.scale = np.full(3, 1.0)
        r.emplace(e, t)
        r.emplace(e, c.MeshSurface(positions=np.asarray(pts, np.float64),
                                   triangles=np.asarray(tris, np.uint32)))
        r.emplace(e, mat or c.VisualMaterial())
        return e

    def light(kind, pos=(0.0, 0.0, 0.0), rot=None, **kw):
        e = r.create()
        t = c.Transform(translation=np.asarray(pos, np.float64))
        if rot is not None:
            t.rotation = np.asarray(rot, np.float64)
        r.emplace(e, t)
        r.emplace(e, c.LightComponent(kind=kind, **kw))

    size = dict(width=GOLDEN_SIZE[0], height=GOLDEN_SIZE[1])
    cam = None
    if name == "supersampled":
        add(*torus_surface(0.5, 0.2, 20, 10),
            mat=c.VisualMaterial(base_color=np.array([0.3, 0.7, 0.45, 1.0])))
        light("directional", color=np.ones(3), intensity=1.0)
        settings = RenderSettings(**size, supersample=2)
    elif name == "cuboid_flat_pointlight":
        add(*cuboid_surface((1, 1, 1)),
            mat=c.VisualMaterial(base_color=np.array([0.8, 0.4, 0.3, 1.0])))
        light("point", pos=(1.5, 2.0, 1.5), intensity=40.0)
        settings = RenderSettings(**size, mode="flat")
    elif name == "spotlight_floor":
        pts, tris = plane_surface((4.0, 4.0))
        add(np.asarray(pts)[:, [0, 2, 1]], tris,
            mat=c.VisualMaterial(base_color=np.array([0.7, 0.7, 0.72, 1.0])))
        spts, stris = icosphere_surface(2)
        add(np.asarray(spts) * 0.3, stris, pos=(0, 0.3, 0),
            mat=c.VisualMaterial(base_color=np.array([0.35, 0.5, 0.8, 1.0])))
        light("spot", pos=(0.0, 2.5, 0.0), rot=(np.cos(np.pi / 4), -np.sin(np.pi / 4), 0, 0),
              intensity=60.0, inner_cone_angle=0.3, outer_cone_angle=0.6)
        cam = orbit_camera(np.zeros(3), 5.0, azimuth_deg=30, elevation_deg=35)
        settings = RenderSettings(**size)
    elif name == "textured_quad":
        pts, tris = plane_surface((2.0, 2.0))
        p = np.asarray(pts)
        yy, xx = np.mgrid[0:64, 0:64]
        checker = ((xx // 8 + yy // 8) % 2).astype(np.uint8)
        tex = np.zeros((64, 64, 4), np.uint8)
        tex[..., 0] = 40 + 200 * checker
        tex[..., 1] = 60 + 140 * (1 - checker)
        tex[..., 2] = 160
        tex[..., 3] = 255
        e = add(pts, tris, mat=c.VisualMaterial(texture=tex))
        r.get(e, c.MeshSurface).uvs = np.stack([(p[:, 0] + 1.0) * 0.5, (p[:, 1] + 1.0) * 0.5], 1)
        light("directional", color=np.ones(3), intensity=1.0)
        settings = RenderSettings(**size)
    elif name == "torus_wireframe":
        add(*torus_surface(0.5, 0.2, 28, 14))
        light("directional", color=np.ones(3), intensity=1.0)
        settings = RenderSettings(**size, mode="wireframe")
    elif name == "ibl_spheres":
        pts, tris = icosphere_surface(2)
        for i, rough in enumerate((0.1, 0.4, 0.8)):
            add(np.asarray(pts) * 0.45, tris, pos=(i * 1.1, 0, 0),
                mat=c.VisualMaterial(base_color=np.array([0.95, 0.95, 0.95, 1.0]),
                                     metallic=1.0, roughness=rough))
        env = np.zeros((32, 64, 3), np.float32)
        env[:16] = (0.3, 0.5, 1.2)
        env[16:] = (0.5, 0.35, 0.2)
        env[4:8, 10:14] = (40.0, 38.0, 30.0)  # sun blob
        settings = RenderSettings(**size, ambient=(0.0, 0.0, 0.0), environment=env)
    else:
        raise KeyError(name)
    return r, cam, settings


def full_width_scene(seed=20261016):
    """The falling scene's 8 bodies (23,552 triangles) at their start poses, each with its
    own material, lit by a directional, a point and a spot light and a seeded IBL map:
    (registry, body entities, RenderSettings at the view command's 960x720, supersample 2)."""
    from mesheditor_tpu_torch.render import RenderSettings
    from mesheditor_tpu_torch.scene import components as c
    from mesheditor_tpu_torch.scene.derive import install_default_pipeline

    rng = np.random.default_rng(seed)
    reg, bodies = falling_scene(seed)
    install_default_pipeline(reg)
    for i, e in enumerate(bodies):
        reg.emplace(e, c.VisualMaterial(base_color=np.append(rng.uniform(0.2, 0.9, 3), 1.0),
                                        metallic=float(i % 3 == 0), roughness=0.2 + 0.1 * i))
    for kind, pos, rot, kw in (
            ("directional", (0.0, 0.0, 0.0), (0.92, -0.38, 0.0, 0.0), dict(intensity=2.0)),
            ("point", (0.0, 1.0, 0.8), (1.0, 0.0, 0.0, 0.0), dict(intensity=3.0)),
            ("spot", (0.5, 1.5, 0.0), (np.cos(np.pi / 4), -np.sin(np.pi / 4), 0.0, 0.0),
             dict(intensity=25.0, inner_cone_angle=0.3, outer_cone_angle=0.7))):
        e = reg.create()
        t = c.Transform(translation=np.asarray(pos, np.float64))
        t.rotation = np.asarray(rot, np.float64)
        reg.emplace(e, t)
        reg.emplace(e, c.LightComponent(kind=kind, **kw))
    env = rng.uniform(0.05, 0.6, (64, 128, 3)).astype(np.float32)
    env[6:12, 20:30] = (30.0, 28.0, 24.0)  # a sun
    return reg, bodies, RenderSettings(width=960, height=720, supersample=2, environment=env)


def band_render(view, batch, env, rows, chunk=256):
    """The given rows of `view`'s supersampled frame, rasterized and shaded from `batch`
    (and the prefiltered `env`) on the batch's device by the port's own chunk step. Each
    pixel is computed on its own, so a row alone holds the bits it holds in the frame.
    Returns (G-buffer of the rows, lit rows)."""
    import torch

    from mesheditor_tpu_torch.render import raster, shade

    dev = batch.device
    w, h = view._rw, view._rh
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    py = (torch.as_tensor(np.asarray(rows), dtype=torch.float32, device=dev) + 0.5)[:, None, None]
    gbuf = raster.GBuffer(
        torch.full((len(rows), w), float("inf"), dtype=torch.float32, device=dev),
        torch.full((len(rows), w), -1, dtype=torch.int32, device=dev),
        torch.zeros((len(rows), w, 3), dtype=torch.float32, device=dev))
    clip = torch.as_tensor(view.clip, device=dev)
    tris = torch.as_tensor(view._tris.astype(np.int64), device=dev)
    for first in range(0, tris.shape[0], chunk):
        raster._rasterize_chunk(clip, tris[first:first + chunk], first, px, py, w, h, False,
                                gbuf)
    s = view.settings
    img = shade(gbuf, view._positions, view._normals, view._tris, view._tri_obj,
                batch.materials, batch.lights, eye=np.asarray(view.camera.eye, np.float32),
                ambient=s.ambient, background=s.background, sky=s.sky, ground=s.ground,
                environment=env)
    return gbuf, img


def render_phase(device, card: str, size=(960, 720), turntable=(36, 480, 360),
                 timing_reps: int = 5) -> dict:
    """Phase i: the render layer. Goldens, the full-width scene (960x720 by default, the
    view command's size) against the CPU's render of the same rows, rasterize/shade times
    by chunk, a turntable recording (frames, width, height) and the view and record
    commands. Returns the numbers it printed. (A rehearsal off the card passes device="cpu",
    smaller sizes and fewer repetitions.)"""
    import torch

    from mesheditor_tpu_torch.render import rasterize, render_scene
    from mesheditor_tpu_torch.render.camera import view_projection
    from mesheditor_tpu_torch.render.environment import prefilter_environment
    from mesheditor_tpu_torch.render.raster import (
        BYTES_PER_PAIR, GBUFFER_BYTES_PER_PIXEL, frame_chunk, project_points, raster_peak_bytes,
        screen_coords)
    from mesheditor_tpu_torch.render.record import read_png, record, turntable_frames
    from mesheditor_tpu_torch.render.scene_render import RenderSettings, flatten_scene
    from mesheditor_tpu_torch.mesh import icosphere_surface, save_obj
    from mesheditor_tpu_torch.scene import components as c

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    out = {}
    # 1. goldens
    for name in RENDER_GOLDENS:
        r, cam, settings = corpus_scene(name)
        t0 = time.perf_counter()
        view = render_scene(r, camera=cam, settings=settings, device=device)
        n_bad, n_contested = golden_check(view, read_png(GOLDEN_DIR / f"{name}.png"))
        limit = CONTESTED_SHARE * settings.width * settings.height
        assert n_bad == n_contested <= limit, \
            f"{name}: {n_bad} pixels off the golden by more than one step, {n_contested} contested"
        log(f"[render] golden {name}: {n_bad} pixels more than one step off, all contested "
            f"(limit {limit:.0f}); {time.perf_counter() - t0:.3f} s")

    # 2. full width: 8 bodies, three lights and an IBL map at 960x720, supersample 2
    reg, bodies, settings = full_width_scene()
    settings.width, settings.height = size
    t0 = time.perf_counter()
    view = render_scene(reg, settings=settings, device=device)
    image = view.image()
    first_s = time.perf_counter() - t0
    n_tris, (rh, rw) = view._tris.shape[0], view.gbuf.tri.shape
    ss = settings.supersample
    assert n_tris == 23_552 and (rh, rw) == (size[1] * ss, size[0] * ss), (n_tris, rh, rw)
    assert image.shape == (size[1], size[0], 3) and np.isfinite(image).all()
    covered = float((view.gbuf.tri >= 0).float().mean())
    assert 0.001 < covered < 0.9, f"covered share {covered}"
    # The CPU's render of the same rows: every 48th row and each body's center row.
    mvp = view_projection(view.camera, settings.width, settings.height)
    centers = np.stack([reg.get(e, c.WorldTransform).matrix[:3, 3] for e in bodies])
    px = screen_coords(project_points(mvp, centers, device="cpu").numpy(), settings.width,
                       settings.height).astype(np.int64)
    rows = sorted(set(range(0, rh, 144)) | {int(y) * ss for _, y in px})
    t0 = time.perf_counter()
    cpu_batch = flatten_scene(reg, device="cpu")
    cpu_env = prefilter_environment(settings.environment, device="cpu")
    cpu_gbuf, cpu_rows = band_render(view, cpu_batch, cpu_env, rows)
    cpu_s = time.perf_counter() - t0
    card_rows = view.shade_frame()[rows].cpu()
    tri, cpu_tri = view.gbuf.tri[rows].cpu().numpy(), cpu_gbuf.tri.numpy()
    differ = np.argwhere(tri != cpu_tri)
    flags = contested_pixels(view.gbuf.tri.cpu().numpy(), view._tris, view.clip,
                             [(rows[y], x) for y, x in differ])
    assert all(flags), f"{len(differ) - sum(flags)} uncontested id differences card vs CPU"
    same = torch.as_tensor(tri == cpu_tri)
    img_err = float((card_rows - cpu_rows).abs()[same].max())
    depth_equal = bool(torch.equal(view.gbuf.depth[rows].cpu()[same], cpu_gbuf.depth[same]))
    bary_err = float((view.gbuf.bary[rows].cpu() - cpu_gbuf.bary).abs()[same].max())
    assert img_err < 1e-4, f"card and CPU rows differ by {img_err:.3e}"
    picks = []
    for e, (x, y) in zip(bodies, px):
        got = view.pick_entity(int(x), int(y))
        t = int(cpu_tri[rows.index(int(y) * ss), int(x) * ss])
        picks.append((got, view.batch.entities[view._tri_obj[t]] if t >= 0 else -1))
    assert all(a == b for a, b in picks), f"picks card vs CPU: {picks}"
    boxed = view.box_select_entities(0, 0, settings.width - 1, settings.height - 1)
    cpu_boxed = sorted({view.batch.entities[i] for i in view._tri_obj[np.unique(cpu_tri[cpu_tri >= 0])]})
    assert sorted(boxed) == cpu_boxed == sorted(bodies), (boxed, cpu_boxed)
    log(f"[render] full width: {len(bodies)} bodies, {n_tris} triangles, {rw}x{rh} rasterized "
        f"for {settings.width}x{settings.height}, {covered:.3f} of the pixels covered; first "
        f"render_scene + image {first_s:.3f} s. CPU render of {len(rows)} rows in {cpu_s:.1f} s: "
        f"{len(differ)} triangle ids differ (all contested), depth bit-equal {depth_equal}, "
        f"bary within {bary_err:.3e}, lit rows within {img_err:.3e}; picks at the {len(bodies)} "
        f"body centers agree ({sum(a >= 0 for a, _ in picks)} on a body), box select names "
        f"all {len(cpu_boxed)} bodies")
    out.update(n_tris=n_tris, covered=covered, contested=len(differ), img_err=img_err)

    # 3. times by chunk: rasterize and shade apart, median of timing_reps after a warm-up;
    # the peak memory of each call against the byte model the derived chunk is sized by
    clip = torch.as_tensor(view.clip, device=dev)
    derived = frame_chunk(settings.chunk, rh, rw, device)
    free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else None
    log(f"[render] derived chunk at {rw}x{rh}: {derived} (budget: half of "
        + ("the CPU's fixed 4 GiB" if free is None else f"{free / 2**30:.2f} GiB free")
        + f"; the G-buffer does not depend on it) ({card})")
    pairs = float(rw * rh) * n_tris
    b_ms, b_by = bound(pairs * RASTER_FLOPS_PER_PAIR, rw * rh * GBUFFER_BYTES_PER_PIXEL)
    log(f"[render] rasterizer bound = max(pixel-triangle pairs x {RASTER_FLOPS_PER_PAIR} float "
        f"operations / {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, G-buffer bytes ({rw}x{rh} x "
        f"{GBUFFER_BYTES_PER_PIXEL}) / {PEAK_BYTES / 1e12:.2f} TB/s) = max({pairs:.4g} x "
        f"{RASTER_FLOPS_PER_PAIR} / {PEAK_F32_FLOPS:.3g}, {rw * rh * GBUFFER_BYTES_PER_PIXEL} / "
        f"{PEAK_BYTES:.3g}) = {b_ms:.3f} ms, bound by {b_by}")
    chunks = {}
    for chunk in (8, 64, 256):
        g = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        times = []
        for _ in range(timing_reps + 1):
            g = None  # one call's G-buffer at a time: the peak is a single call's
            sync()
            t0 = time.perf_counter()
            g = rasterize(clip, view._tris, rw, rh, chunk=chunk, device=device)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base if dev.type == "cuda" else None
        assert all(torch.equal(a, b) for a, b in zip(g, view.gbuf)), f"chunk {chunk} differs"
        del g
        model = raster_peak_bytes(rh, rw, chunk)
        assert peak is None or abs(peak / model - 1.0) < PEAK_MODEL_RTOL, \
            f"chunk {chunk}: peak {peak} bytes against the byte model's {model}"
        chunks[chunk] = {"rasterize_ms": float(np.median(times[1:])), "peak_bytes": peak,
                         "model_bytes": model}
    shade_times = []
    for _ in range(timing_reps + 1):
        sync()
        t0 = time.perf_counter()
        view.shade_frame()
        sync()
        shade_times.append((time.perf_counter() - t0) * 1e3)
    shade_ms = float(np.median(shade_times[1:]))
    for chunk, rec in chunks.items():
        peak = "not measured" if rec["peak_bytes"] is None else (
            f"{rec['peak_bytes'] / 2**30:.3f} GiB above the allocations before the call")
        log(f"[render] chunk {chunk:3d}: rasterize {rec['rasterize_ms']:.1f} ms (median of "
            f"{timing_reps} after a warm-up, {rec['rasterize_ms'] / b_ms:.0f}x the bound), peak "
            f"memory {peak}, byte model {rec['model_bytes'] / 2**30:.3f} GiB ({rw}x{rh} x "
            f"({GBUFFER_BYTES_PER_PIXEL} + {BYTES_PER_PAIR} x {chunk}) bytes); G-buffer bit-identical to the "
            f"derived chunk {derived}'s ({card})")
    timed = derived if derived in chunks else 256
    log(f"[render] shade {shade_ms:.1f} ms at {rw}x{rh} (3 lights + IBL; median of "
        f"{timing_reps}); shade share of rasterize + shade at chunk {timed}: "
        f"{shade_ms / (shade_ms + chunks[timed]['rasterize_ms']):.3f} ({card})")
    out.update(chunks=chunks, shade_ms=shade_ms, bound_ms=b_ms, derived_chunk=derived)
    if dev.type == "cuda":
        # One frame (rasterize at the default chunk, then shade) under torch.profiler.
        def frame():
            rasterize(clip, view._tris, rw, rh, chunk=derived, device=device)
            view.shade_frame()
            sync()

        wall_us, by_name = device_profile(frame)
        busy = sum(t for _n, t in by_name.values())
        launches = sum(n for _t, (n, _u) in by_name.items())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        out["profile"] = {
            "wall_ms": wall_us / 1e3, "device_ms": busy / 1e3, "launches": launches,
            "idle_share": 1.0 - busy / wall_us if busy else None,
            "top": [{"name": n[:70], "count": c, "ms": t / 1e3, "share": t / busy}
                    for n, (c, t) in top]}
        log(f"[profile] render frame at chunk {derived} ({card}): " + json.dumps(out["profile"]))

    # 4. turntable: 36 frames of icosphere(4) at 480x360 written as PNG frames
    pts, tris = icosphere_surface(4)
    n_frames, tw, th = turntable
    with tempfile.TemporaryDirectory(prefix="chip_smoke_render_") as tmp:
        t0 = time.perf_counter()
        path = record(Path(tmp) / "turntable.png", turntable_frames(
            pts, tris, n_frames=n_frames, settings=RenderSettings(tw, th), device=device))
        per_frame = (time.perf_counter() - t0) / n_frames * 1e3
        frames = sorted(Path(tmp).glob("turntable_*.png"))
        first, last = read_png(frames[0]), read_png(frames[-1])
        assert path.suffix == ".png" and len(frames) == n_frames and first.shape == (th, tw, 3)
        assert (first != last).any() and first.std() > 1.0, "the turntable does not turn"
        log(f"[render] turntable: {n_frames} frames of icosphere(4) ({len(tris)} triangles) at "
            f"{tw}x{th} to PNG, {per_frame:.1f} ms a frame, PNG writing included ({card})")
        out["turntable_ms_per_frame"] = per_frame

        # 5. the view and record commands as fresh processes
        save_obj(Path(tmp) / "ball.obj", pts, tris)
        for argv, check in (
                (["view", "ball.obj", "--out", "view.png", "--width", str(size[0]),
                  "--height", str(size[1])], lambda: read_png(Path(tmp) / "view.png")),
                (["record", "ball.obj", "--out", "spin.png", "--frames", "6", "--width",
                  str(tw), "--height", str(th)], lambda: read_png(Path(tmp) / "spin_0005.png"))):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "mesheditor_tpu_torch", *argv,
                                   "--device", device], cwd=tmp, capture_output=True,
                                  text=True, timeout=300,
                                  env=dict(os.environ, PYTHONPATH=str(REPO)))
            assert proc.returncode == 0, f"{argv[0]} exited {proc.returncode}:\n{proc.stderr}"
            img = check()
            assert img.std() > 1.0, f"{argv[0]} wrote a flat image"
            log(f"[cli] {argv[0]} ({time.perf_counter() - t0:.1f} s): {img.shape[1]}x"
                f"{img.shape[0]} PNG | " + " | ".join(proc.stdout.strip().splitlines()[-2:]))
    return out


# ---- phase j: files (glTF I/O, the commands on a glTF scene, sessions, RealImpact) ----

REALIMPACT_SCALE = (0.15, 0.12, 0.095)  # tests/test_realimpact_loader.py's bowl-sized ellipsoid
REALIMPACT_OBJECT = "9_BowlCeramic"
# scipy's sparse LU of the scan's mesh at bbox/10 (47k dofs) takes ~40 s on one host
# core; at bbox/24 (125k dofs) its fill, and its time, grow faster than the dofs. So the
# solve is held to scipy on the same scan meshed at bbox/10.
ORACLE_TET_RESOLUTION = 10


def bound_falling_scene(bodies):
    """falling_scene() with each body's density and stored ModalModel as `bodies` gives
    them: the scene a reload from the store sees. Returns (registry, body entities)."""
    from mesheditor_tpu_torch.scene import components as c

    reg, es = falling_scene()
    for e, (density, model) in zip(es, bodies):
        reg.get(e, c.AcousticMaterialRef).density = density
        reg.emplace(e, replace(model))
    return reg, es


def session_through_actions(root):
    """A crash-recovery session under `root`, written through actions (the log is written
    on its writer thread and flushed by close). Returns (the live scene's snapshot, the
    session directory)."""
    from mesheditor_tpu_torch.scene import actions as A
    from mesheditor_tpu_torch.scene.session import Session
    from mesheditor_tpu_torch.scene.snapshot import snapshot_scene

    session = Session(root=root)
    for action in (
            A.AddObject(name="bowl"), A.AddPrimitive(name="ring", kind="torus", size=0.1),
            A.SetTransform(entity=1, translation=(0.1, 0.2, 0.3),
                           rotation=(0.9238795, 0.0, 0.3826834, 0.0)),
            A.SetAcousticMaterial(entity=1, name="Glass"), A.SetParent(entity=2, parent=1),
            A.SetGain(entity=2, value=0.5), A.SetFundamental(entity=1, freq=440.0),
            A.SetField(entity=1, component="AcousticMaterialRef", field_name="density",
                       value=1e9),  # clamped to the limit table's 30,000
            A.StrikeVertex(entity=1, vertex=3, impulse=(0.0, 1.0, 0.0))):
        session.apply(action)
        session.process()
    session.close()
    return snapshot_scene(session.registry), session.dir


def write_realimpact_scan(root: Path, name: str = REALIMPACT_OBJECT,
                          scale=REALIMPACT_SCALE) -> Path:
    """A miniature RealImpact object directory `name` under `root`, the recipe of
    tests/test_realimpact_loader.py: the dataset's metadata arrays from a seed, the mesh
    `icosphere_surface(4)` scaled to an ellipsoid (by default 15 cm and bowl-sized; the
    anisotropic scale splits the sphere's degenerate pairs) and the five impact vertices on
    it. The recordings come later (`write_recordings`). Returns the directory."""
    from mesheditor_tpu_torch.io.realimpact import NUM_IMPACT_VERTICES, NUM_LISTENER_POINTS
    from mesheditor_tpu_torch.mesh import icosphere_surface, save_obj

    obj_dir = root / name
    pre = obj_dir / "preprocessed"
    pre.mkdir(parents=True)
    rng = np.random.default_rng(0)
    n = NUM_LISTENER_POINTS
    np.save(pre / "angle.npy", np.repeat(np.arange(10) * 36, 60)[:n])
    np.save(pre / "distance.npy", np.tile(np.repeat([250, 500, 750, 1000], 15), 10)[:n])
    np.save(pre / "micID.npy", np.tile(np.arange(15), 40)[:n])
    np.save(pre / "listenerXYZ.npy", rng.uniform(-2000, 2000, (n, 3)))
    pts, tris = icosphere_surface(4)
    scale3 = np.asarray(scale)
    save_obj(pre / "transformed.obj", pts * scale3, tris)
    np.save(pre / "vertexXYZ.npy", np.repeat(pts[:NUM_IMPACT_VERTICES] * scale3, n, axis=0))
    return obj_dir


def write_recordings(obj_dir: Path, result) -> None:
    """The scan's "recordings" at listener point 0: each impact rings at the solved
    frequencies and decay rates of `result`, weighted by each mode's coupling to a strike
    along y at the vertex (modes under a tenth of the strongest are left out). Only those
    five rows are written; the rest of the file stays sparse."""
    from mesheditor_tpu_torch.io.realimpact import NUM_IMPACT_VERTICES, NUM_LISTENER_POINTS

    freqs = np.asarray(result.modes.freqs, np.float64)
    shapes = np.asarray(result.modes.shapes, np.float64)
    expos_of = np.asarray(result.sample_point_of_excitation, np.int64)
    rates = 6.9078 / np.maximum(np.asarray(result.modes.t60s, np.float64), 1e-3)
    t = np.arange(24_000) / 48_000.0
    n = NUM_LISTENER_POINTS
    rows = np.lib.format.open_memmap(obj_dir / "preprocessed" / "deconvolved_0db.npy",
                                     mode="w+", dtype=np.float32,
                                     shape=(n * NUM_IMPACT_VERTICES, t.size))
    for v in range(NUM_IMPACT_VERTICES):
        amp = np.abs(shapes[int(expos_of[min(v, expos_of.size - 1)]), :, 1])
        amp = np.where(amp > 0.1 * amp.max(), amp, 0.0)
        rows[n * v] = sum(a * np.exp(-t * r) * np.sin(2 * np.pi * f * t)
                          for f, a, r in zip(freqs, amp, rates) if a > 0)
    rows.flush()


ORACLE_CODE = """
import sys, time, types
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke
m = np.load(sys.argv[2])
mesh = types.SimpleNamespace(points=m["points"], tets=m["tets"])
t0 = time.perf_counter()
np.save(sys.argv[3], chip_smoke.host_oracle(mesh, int(sys.argv[4]), float(sys.argv[5])))
print(time.perf_counter() - t0)
"""


def start_oracle(mesh, n_eig: int, sigma: float, tmp: Path) -> tuple:
    """host_oracle(mesh, n_eig, sigma) in a process of its own, so that its sparse
    factorization (minutes at ~10^5 dofs) runs beside the work that follows. Returns (the
    process, the .npy path its eigenvalues land in)."""
    np.savez(tmp / "oracle_mesh.npz", points=mesh.points, tets=mesh.tets)
    out = tmp / "oracle_eigenvalues.npy"
    proc = subprocess.Popen([sys.executable, "-c", ORACLE_CODE, str(REPO),
                             str(tmp / "oracle_mesh.npz"), str(out), str(n_eig), repr(sigma)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out


def files_phase(device, card: str, store, bodies=None, tet_resolution: int = 24,
                sizes=None) -> dict:
    """Phase j: the falling scene (its models from `store`, bound as `bodies` gives them;
    solved into `store` first when None) exported to .glb with the models embedded,
    imported into a fresh store, exported and imported again: a fixed point, played with
    no solve, bit for bit the same audio from both imports; the simulate, view
    --debug-physics, record and sessions commands as subprocesses on that file; compare_scan
    on a miniature RealImpact scan. Every block that the two simulate_scene runs and
    compare_scan render is held against the plain version (blocks_against_plain). Returns,
    for each kernel, its launches in the phase's own process and the parity record of its
    blocks. (A rehearsal off the card passes a coarser tet_resolution and smaller `sizes`:
    {"seconds", "video", "view", "record"}.)"""
    from mesheditor_tpu_torch.api import _tetrahedralize, solve_surface
    from mesheditor_tpu_torch.io.gltf import export_gltf, import_gltf
    from mesheditor_tpu_torch.io.project import load_project
    from mesheditor_tpu_torch.io.realimpact import load_realimpact_scan
    from mesheditor_tpu_torch.io.realimpact_harness import compare_scan
    from mesheditor_tpu_torch.materials import find_material
    from mesheditor_tpu_torch.physics.scene_build import build_world
    from mesheditor_tpu_torch.render.record import read_png
    from mesheditor_tpu_torch.scene import components as c
    from mesheditor_tpu_torch.scene.audio_sync import SceneAudio, simulate_scene
    from mesheditor_tpu_torch.scene.snapshot import snapshot_scene
    from mesheditor_tpu_torch.solve import lobpcg
    from mesheditor_tpu_torch.synth import coupled, impact
    from mesheditor_tpu_torch.types import ModalSolveSettings

    sizes = {"seconds": 0.5, "video": (0.25, 480, 360), "view": (960, 720),
             "record": (6, 480, 360), **(sizes or {})}
    if bodies is None:  # run alone: solve the scene into the store first
        reg, es = falling_scene()
        t0 = time.perf_counter()
        report = SceneAudio(reg, store, tet_resolution=tet_resolution, device=device).reconcile()
        assert report.solved == es, f"solved {report.solved}"
        bodies = [(reg.get(e, c.AcousticMaterialRef).density, reg.get(e, c.ModalModel))
                  for e in es]
        log(f"[files] the falling scene's {len(es)} bodies solved into a temporary store in "
            f"{time.perf_counter() - t0:.1f} s")
    impact.LAUNCHES = coupled.LAUNCHES = 0
    lobpcg.DEVICE_SOLVES = lobpcg.HOST_SOLVES = 0
    settings = ModalSolveSettings(num_modes=6, num_vertices=4, max_mode_freq=20_000.0)
    sigma = -((2 * np.pi * settings.min_mode_freq) ** 2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as tmp, \
            contextlib.ExitStack() as stack:
        tmp = Path(tmp)
        # every block rendered in this process, held against the plain version
        parity = stack.enter_context(blocks_against_plain())
        # 0. a miniature RealImpact scan, and scipy's eigenvalues of the mesh its solve
        # will build, in a process of its own from here on
        scan_dir = write_realimpact_scan(tmp / "realimpact")
        scan = load_realimpact_scan(scan_dir)
        oracle_res = min(ORACLE_TET_RESOLUTION, tet_resolution)
        mesh = _tetrahedralize(scan.positions, scan.triangles, oracle_res, False)
        oracle, oracle_out = start_oracle(mesh, 16, sigma, tmp)
        stack.callback(oracle.kill)

        # 1. glTF: export, import, export, import; the two imports are one scene.
        reg, es = bound_falling_scene(bodies)
        glb, glb2, fresh = tmp / "falling.glb", tmp / "again.glb", tmp / "fresh_store"
        t0 = time.perf_counter()
        export_gltf(reg, glb)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        first = import_gltf(glb, store_dir=fresh)
        import_s = time.perf_counter() - t0
        export_gltf(first, glb2)
        second = import_gltf(glb2, store_dir=fresh)
        snap = snapshot_scene(first)
        assert snap == snapshot_scene(second), "import -> export -> import is not a fixed point"
        n_models = len(list(first.view(c.ModalModel)))
        assert n_models == len(es), f"{n_models} models embedded, not {len(es)}"
        log(f"[files] export {export_s:.3f} s ({glb.stat().st_size} bytes, {len(es)} models "
            f"embedded), import {import_s:.3f} s into a fresh store; the second import's "
            f"snapshot equals the first's ({len(snap)} bytes) ({card})")
        audio = []
        for name, r in (("first", first), ("second", second)):
            report = SceneAudio(r, fresh, tet_resolution=tet_resolution, device=device).reconcile()
            assert not report.solved and len(report.loaded) == len(es), f"{name}: {report}"
            before = (impact.LAUNCHES, coupled.LAUNCHES)
            t0 = time.perf_counter()
            audio.append(simulate_scene(r, fresh, seconds=sizes["seconds"],
                                        tet_resolution=tet_resolution, device=device))
            sim_s = time.perf_counter() - t0
            got = (impact.LAUNCHES - before[0], coupled.LAUNCHES - before[1])
            assert got[0] > 0 and got[1] > 0, f"{name} import: kernel launches {got}"
            log(f"[files] {name} import: reconcile solved nothing and loaded {len(report.loaded)}; "
                f"simulate_scene {sizes['seconds']} s in {sim_s:.3f} s, impact launches "
                f"{got[0]}, coupled launches {got[1]} ({card})")
        assert lobpcg.DEVICE_SOLVES == lobpcg.HOST_SOLVES == 0, "an imported scene was solved"
        assert np.isfinite(audio[0]).all() and np.abs(audio[0]).max() > 0, "silent or not finite"
        assert np.array_equal(audio[0], audio[1]), "the two imports sound different"
        for kind in parity:
            assert parity[kind]["sounding_blocks"] > 0, f"no sounding {kind} block was checked"
        log(f"[files] both imports' audio bit-identical: {audio[0].size} samples, peak "
            f"{float(np.abs(audio[0]).max()):.4e}; their blocks against the plain version on "
            f"host copies of their inputs: " + json.dumps(parity))

        # 2. the commands as subprocesses on the exported file
        def run(*argv):
            """One command as a fresh process; the glTF commands run on `device`."""
            if argv[0] != "sessions":
                argv = (*argv, "--device", device)
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "mesheditor_tpu_torch", *argv],
                                  cwd=tmp, capture_output=True, text=True, timeout=600,
                                  env=dict(os.environ, PYTHONPATH=str(REPO)))
            assert proc.returncode == 0, f"{argv[0]} exited {proc.returncode}:\n{proc.stderr}"
            log(f"[cli] {argv[0]} ({time.perf_counter() - t0:.1f} s): "
                + " | ".join(proc.stdout.replace("\r", "\n").strip().splitlines()[-3:]))
            return proc.stdout

        secs, vw, vh = sizes["video"]
        text = run("simulate", glb.name, "--seconds", str(secs), "--out", "sim.wav", "--store",
                   "sim_store", "--video", "frames.png", "--video-width", str(vw),
                   "--video-height", str(vh))
        frames = sorted(tmp.glob("frames_*.png"))
        assert "solve progress" not in text, "simulate solved a model the file carries"
        assert (tmp / "sim.wav").stat().st_size > 44 and frames, "simulate wrote no wav or frames"
        assert read_png(frames[0]).shape == (vh, vw, 3)
        w, h = sizes["view"]
        text = run("view", glb.name, "--debug-physics", "--out", "view.png", "--width", str(w),
                   "--height", str(h))
        world, _ = build_world(first)
        assert f"debug overlay: {len(world.bodies)} collider wireframes" in text, text
        assert read_png(tmp / "view.png").std() > 1.0, "view wrote a flat image"
        n_rec, rw, rh = sizes["record"]
        run("record", glb.name, "--out", "spin.png", "--frames", str(n_rec), "--width", str(rw),
            "--height", str(rh))
        spun = sorted(tmp.glob("spin_*.png"))
        assert len(spun) == n_rec and (read_png(spun[0]) != read_png(spun[-1])).any()
        live, session_dir = session_through_actions(tmp / "sessions")
        text = run("sessions", "restore", "--root", str(tmp / "sessions"), "--out", "s.project")
        assert "replay self-test: byte-exact" in text, text
        assert snapshot_scene(load_project(tmp / "s.project")) == live, \
            "the project does not hold the session's scene"
        log(f"[files] {len(frames)} video frames, view overlay {len(world.bodies)} bodies, "
            f"{n_rec} record frames; session {session_dir.name} restored byte-exact into a "
            f".project whose snapshot is the live scene's ({len(live)} bytes)")

        # 3. RealImpact: compare_scan on a miniature scan, and the solve against scipy
        t0 = time.perf_counter()
        truth = solve_surface(scan.positions, scan.triangles, find_material("Ceramic").properties,
                              excite_positions=scan.impact_positions, settings=settings,
                              tet_resolution=tet_resolution, device=device)
        write_recordings(scan_dir, truth)
        before = impact.LAUNCHES
        sounding = parity["impact"]["sounding_blocks"]
        t1 = time.perf_counter()
        report = compare_scan(scan_dir, seconds=0.5, settings=settings,
                              tet_resolution=tet_resolution, device=device)
        compare_s = time.perf_counter() - t1
        assert impact.LAUNCHES > before, "compare_scan did not launch the impact kernel"
        assert parity["impact"]["sounding_blocks"] > sounding, \
            "no sounding compare_scan block was checked against the plain version"
        assert report.median_cents < 30.0 and report.match_fraction >= 0.5, \
            (report.median_cents, report.match_fraction)
        log(f"[realimpact] scan written and solved in {t1 - t0:.1f} s ({truth.profile.dofs} "
            f"dofs, {truth.modes.num_modes} modes); compare_scan {compare_s:.1f} s: median "
            f"{report.median_cents:.3f} cents, match fraction {report.match_fraction:.3f}, "
            f"impact launches {impact.LAUNCHES - before}, each block held against the plain "
            f"version, all phase j's blocks now: {json.dumps(parity['impact'])} ({card})")
        checked = {kind: parity[kind]["blocks"] for kind in parity}
        launched = {"impact": impact.LAUNCHES, "coupled": coupled.LAUNCHES}
        assert checked == launched, f"checked blocks {checked} against launches {launched}"
        coarse = solve_surface(scan.positions, scan.triangles,
                               find_material("Ceramic").properties,
                               excite_positions=scan.impact_positions, settings=settings,
                               tet_resolution=oracle_res, device=device)
        t0 = time.perf_counter()
        text, err = oracle.communicate(timeout=900)
        assert oracle.returncode == 0, f"the scipy oracle exited {oracle.returncode}:\n{err}"
        ref = np.load(oracle_out)
        got = coarse.summary.eigenvalues[6:16]
        rel_f = np.abs(np.sqrt(got) / np.sqrt(ref[6:6 + got.size]) - 1.0)
        assert rel_f.max() < 1e-5, f"RealImpact solve off scipy by {rel_f.max():.3e}"
        log(f"[realimpact] the scan solved at bbox/{oracle_res} ({coarse.profile.dofs} dofs) "
            f"against scipy eigsh on the same mesh ({mesh.points.shape[0]} points, "
            f"{mesh.tets.shape[0]} tets; scipy {float(text):.1f} s in a process of its own, "
            f"waited {time.perf_counter() - t0:.1f} s for it at the end): "
            f"solve {np.round(np.sqrt(got) / (2 * np.pi), 2).tolist()} Hz, scipy "
            f"{np.round(np.sqrt(ref[6:6 + got.size]) / (2 * np.pi), 2).tolist()} Hz, within "
            f"{rel_f.max():.3e} relative")
    return {kind: {"launches": launched[kind], **parity[kind]} for kind in launched}


# ---- phase k: the viewer (the edit command): repaint, pick, gizmo, strike-to-audio ----

VIEWER_SIZE = (960, 600)  # edit's defaults (supersample 1)
TINT = (255, 160, 40)  # the viewer's selection blend colour


def to_pixels(app, points) -> np.ndarray:
    """World points -> (N, 2) pixel coordinates in the app's current view, on the host."""
    from mesheditor_tpu_torch.render.camera import view_projection
    from mesheditor_tpu_torch.render.raster import project_points, screen_coords

    mvp = view_projection(app.camera(), app.width, app.height)
    return screen_coords(project_points(mvp, points, device="cpu").numpy(), app.width,
                         app.height)


def projected_center(app, entity) -> tuple[int, int]:
    """The pixel at the centre of an entity's projected bounds in the app's current view."""
    from mesheditor_tpu_torch.scene import components as c

    r = app.registry
    r.process()
    m = np.asarray(r.get(entity, c.WorldTransform).matrix, np.float64)
    p = np.asarray(r.get(entity, c.MeshSurface).positions, np.float64) @ m[:3, :3].T + m[:3, 3]
    xy = to_pixels(app, p)
    x, y = (xy.min(0) + xy.max(0)) / 2
    return int(x), int(y)


def gizmo_pixel(app) -> tuple[int, int]:
    """A pixel on the selected entity's x-axis translate handle: the first point along the
    projected centre-to-tip segment (from 40% of the way out) that grabs an axis handle."""
    from mesheditor_tpu_torch.render.gizmo import handle_points, pick_handle

    cam, center, size = app.camera(), app._gizmo_center(), app.radius * 0.18
    o, tip = to_pixels(app, np.stack([center, handle_points(center, size)["tips"][0]]))
    for t in np.linspace(0.4, 1.0, 25):
        x, y = o + t * (tip - o)
        h = pick_handle(cam, app.width, app.height, x, y, center, mode="translate", size=size)
        if h is not None and not h.plane:
            return int(x), int(y)
    raise AssertionError("no axis handle of the gizmo can be grabbed on screen")


def http(base: str, path: str, body=None, timeout: float = 600.0) -> tuple[int, bytes, float]:
    """One request to the viewer's server, timed from request to full response: (status,
    body, seconds)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, data=data),
                                    timeout=timeout) as r:
            code, payload = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, payload = e.code, e.read()
    return code, payload, time.perf_counter() - t0


def edit_subprocess(device, card: str, glb: Path, tmp: Path, size, block: int,
                    click: tuple[int, int]) -> None:
    """`python -m mesheditor_tpu_torch edit <glb> --audio --port 0` as a fresh process with
    HOME in `tmp`: it prints the port it bound; then an orbit, a click on `block` at
    `click` (the pixel after that orbit), strike mode, a strike, a frame, the audio, a bad
    inspect query, the physics panel and a replay check, each timed. Fails if the process
    exits on its own or writes a traceback."""
    from mesheditor_tpu_torch.render.record import decode_png

    home = tmp / "home"
    home.mkdir()
    env = dict(os.environ, HOME=str(home), PYTHONPATH=str(REPO))
    env.pop("MESHEDITOR_TPU_SESSION_DIR", None)
    w, h = size
    out, err = (open(tmp / f"edit_{n}.txt", "w") for n in ("out", "err"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mesheditor_tpu_torch", "edit", str(glb), "--audio", "--port",
         "0", "--width", str(w), "--height", str(h), "--device", device],
        cwd=tmp, stdout=out, stderr=err, env=env)
    try:
        base = None
        while base is None:
            assert proc.poll() is None, f"edit exited {proc.returncode}:\n" + \
                (tmp / "edit_err.txt").read_text()
            assert time.perf_counter() - t0 < 300, "edit printed no address in 300 s"
            found = [line for line in (tmp / "edit_out.txt").read_text().splitlines()
                     if line.startswith("viewer on http://127.0.0.1:")]
            if found:
                base = found[0].split()[2].rstrip("/")
            else:
                time.sleep(0.1)
        printed_s = time.perf_counter() - t0
        code, body, state_s = http(base, "/state")
        assert code == 200, code
        first_state_s = time.perf_counter() - t0
        session_dir = Path(json.loads(body)["session_dir"])
        assert session_dir.parent == home / ".mesheditor_tpu" / "sessions", session_dir
        walls = {"state": state_s}
        x, y = click
        for name, path, ev in (
                ("orbit", "/event", {"type": "orbit", "dx": 8, "dy": 0}),
                ("click", "/event", {"type": "click", "x": x, "y": y}),
                ("strike mode", "/event", {"type": "mode", "mode": "strike"}),
                ("strike", "/event", {"type": "click", "x": x, "y": y})):
            code, body, walls[name] = http(base, path, ev)
            assert code == 200, (name, code, body[:200])
            st = json.loads(body)
            if name == "click":
                assert st["selected"] == block, f"the click selected {st['selected']}"
        assert st["struck"] and st["has_audio"], st["audio"]
        code, body, walls["frame"] = http(base, "/frame")
        assert code == 200 and body[25] == 2, "the frame is not an RGB PNG"
        assert decode_png(body).shape == (h, w, 4), decode_png(body).shape
        code, body, walls["audio"] = http(base, "/audio")
        assert code == 200 and body[:4] == b"RIFF" and body[8:12] == b"WAVE", body[:12]
        code, body, walls["inspect abc"] = http(base, "/inspect?entity=abc")
        assert code == 400 and "error" in json.loads(body), (code, body)
        code, body, walls["physics"] = http(base, "/physics")
        assert code == 200 and json.loads(body)["bodies"], body[:200]
        code, body, walls["verify-replay"] = http(base, "/verify-replay", {})
        assert code == 200 and json.loads(body)["byte_exact"], body
        assert proc.poll() is None, f"edit exited on its own ({proc.returncode})"
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        out.close()
        err.close()
    errors = (tmp / "edit_err.txt").read_text()
    assert "Traceback" not in errors, errors
    log(f"[viewer] edit subprocess: address printed {printed_s:.2f} s, first /state answered "
        f"{first_state_s:.2f} s after start; request walls (s): "
        + json.dumps({k: round(v, 4) for k, v in walls.items()}) + f" ({card})")


def viewer_phase(device, card: str, size=VIEWER_SIZE, orbits: int = 5,
                 edit_process: bool = True) -> dict:
    """Phase k: the falling scene (a plane and 8 bodies, 23,552 triangles) exported to .glb
    and opened by ViewerApp at `size` with audio on, in process: the cold frame, the frame
    after an orbit (median of `orbits`, rasterize and shade from the profile scopes), a
    click on a wooden block at the centre of its projected bounds (selects it), the tinted
    frame (exactly the block's pick mask is tinted), a translate drag (the block moves, one
    SetTransform action a move), strike mode and a strike on the block: every surface
    solved (per entity: dofs, modes, f1, seconds, the path that answered, or the recorded
    error), 3 impact launches and no coupled launch, each block held against the plain
    version, audible, its spectrum's peaks on the block's solved frequencies, the session
    byte-exact on replay; then `edit` as a fresh process over HTTP. Returns each kernel's
    launches in the strike and the parity record of its blocks. (A rehearsal off the card
    passes a smaller `size` and fewer `orbits`.)"""
    import torch

    from mesheditor_tpu_torch import api, profile
    from mesheditor_tpu_torch.app import ViewerApp
    from mesheditor_tpu_torch.io.gltf import export_gltf, import_gltf
    from mesheditor_tpu_torch.render.raster import frame_chunk
    from mesheditor_tpu_torch.render.record import decode_png
    from mesheditor_tpu_torch.scene import components as c
    from mesheditor_tpu_torch.solve import lobpcg
    from mesheditor_tpu_torch.synth import coupled, impact

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    w, h = size
    with tempfile.TemporaryDirectory(prefix="chip_smoke_viewer_") as tmp, \
            contextlib.ExitStack() as stack:
        tmp = Path(tmp)
        glb = tmp / "falling.glb"
        export_gltf(falling_scene()[0], glb)
        reg = import_gltf(glb)
        blocks = [e for e, rb in sorted(reg.view(c.RigidBodyComponent)) if rb.shape_kind == "box"]
        assert len(blocks) == 4, f"wooden blocks {blocks}"
        block = blocks[0]
        t0 = time.perf_counter()
        app = ViewerApp(reg, w, h, session_root=tmp / "sessions", audio=True, device=device)
        app_s = time.perf_counter() - t0

        # 1. frames: cold, then after an orbit (rasterize and shade from the profile)
        t0 = time.perf_counter()
        app.frame_png()
        sync()
        cold_s = time.perf_counter() - t0
        n_tris = int(app._renderer_cache.batch.triangles.shape[0])
        assert n_tris == 23_552, f"{n_tris} triangles"
        profile.reset()
        profile.enabled = True
        walls = []
        try:
            for _ in range(orbits):
                app.handle({"type": "orbit", "dx": 8, "dy": 0})
                t0 = time.perf_counter()
                app.frame_png()
                sync()
                walls.append(time.perf_counter() - t0)
        finally:
            profile.enabled = False
        scopes = profile.totals()
        rast_n, rast_s = scopes["render/rasterize"]
        shade_n, shade_s = scopes["render/shade"]
        assert rast_n == shade_n == orbits, scopes
        chunk = frame_chunk(None, h, w, dev)
        log(f"[viewer] ViewerApp on the .glb ({len(reg.entities())} entities, {n_tris} "
            f"triangles) at {w}x{h}: app {app_s:.3f} s, cold frame_png {cold_s:.3f} s; after an "
            f"orbit frame_png median {np.median(walls) * 1e3:.1f} ms of {orbits} (all "
            f"{[round(x * 1e3, 1) for x in walls]}), rasterize {rast_s / rast_n * 1e3:.1f} ms "
            f"and shade {shade_s / shade_n * 1e3:.2f} ms a frame (profile scopes), derived "
            f"chunk {chunk} ({card})")

        # 2. picking: a click at the block's centre selects it; the tint is its pick mask
        x, y = projected_center(app, block)
        st = app.handle({"type": "click", "x": x, "y": y})
        assert st["selected"] == block, f"the click at {(x, y)} selected {st['selected']}"
        t0 = time.perf_counter()
        tinted = decode_png(app.frame_png())[..., :3]
        sync()
        tint_s = time.perf_counter() - t0
        rend = app._renderer_cache
        tri = rend.gbuf.tri.cpu().numpy()
        row = rend.batch.entities.index(block)
        mask = np.zeros(tri.shape, bool)
        mask[tri >= 0] = rend._tri_obj[tri[tri >= 0]] == row
        base = np.clip(rend.image() * 255.0, 0, 255).astype(np.uint8)
        want = base.copy()
        want[mask] = (0.6 * base[mask] + 0.4 * np.array(TINT)).astype(np.uint8)
        assert mask.sum() > 0 and np.array_equal(tinted, want), \
            "the tinted pixels are not the block's pick mask"
        rng = np.random.default_rng(20261017)
        for py, px in [(y, x), *zip(rng.integers(0, h, 64), rng.integers(0, w, 64))]:
            assert (rend.pick_entity(int(px), int(py)) == block) == mask[py, px], (px, py)
        log(f"[viewer] click at {(x, y)} selected block {block}; tinted frame {tint_s:.3f} s: "
            f"its {int(mask.sum())} tinted pixels are exactly the block's pick mask (a host "
            f"copy of gbuf.tri through _tri_obj)")

        # 3. gizmo: a translate drag moves the block, one SetTransform action a move
        app.handle({"type": "mode", "mode": "translate"})
        gx, gy = gizmo_pixel(app)
        before = np.asarray(reg.get(block, c.Transform).translation, np.float64).copy()
        app.handle({"type": "drag_start", "x": gx, "y": gy})
        assert app.drag is not None, "the drag did not grab the handle"
        for dx in (12, 24):
            app.handle({"type": "drag_move", "x": gx + dx, "y": gy})
        app.handle({"type": "drag_end"})
        after = np.asarray(app.registry.get(block, c.Transform).translation, np.float64)
        assert not np.allclose(before, after), "the drag did not move the block"
        app.session.log.drain()
        moves = (app.session.dir / "actions.log").read_text().count('"t":"SetTransform"')
        assert moves == 2, f"{moves} SetTransform actions for 2 moves"
        t0 = time.perf_counter()
        app.frame_png()
        sync()
        gizmo_s = time.perf_counter() - t0
        log(f"[viewer] translate drag from {(gx, gy)}: block moved by "
            f"{np.round(after - before, 4).tolist()} m, {moves} SetTransform actions logged; "
            f"frame with the gizmo {gizmo_s:.3f} s")

        # 4. strike: every surface solved, then 1 s rendered through the impact kernel
        app.handle({"type": "mode", "mode": "strike"})
        x, y = projected_center(app, block)
        solves = []
        inner = api.solve_surface

        def timed_solve(*args, **kwargs):
            paths = (lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES)
            t0 = time.perf_counter()
            rec = {"entity": len(solves)}
            solves.append(rec)
            try:
                res = inner(*args, **kwargs)
            except ValueError as exc:
                rec["error"] = str(exc)[:80]
                raise
            finally:
                sync()
                rec["s"] = round(time.perf_counter() - t0, 3)
            f1 = float(res.modes.freqs[0]) if res.modes.num_modes else None
            rec.update(dofs=int(res.profile.dofs), modes=int(res.modes.num_modes),
                       f1=f1 and round(f1, 2), iterations=int(res.profile.restarts),
                       device_solves=lobpcg.DEVICE_SOLVES - paths[0],
                       host_solves=lobpcg.HOST_SOLVES - paths[1])
            return res

        api.solve_surface = timed_solve
        stack.callback(setattr, api, "solve_surface", inner)
        impact.LAUNCHES = coupled.LAUNCHES = 0
        with blocks_against_plain() as parity:
            t0 = time.perf_counter()
            st = app.handle({"type": "click", "x": x, "y": y})
            sync()
            first_s = time.perf_counter() - t0
        api.solve_surface = inner
        launched = {"impact": impact.LAUNCHES, "coupled": coupled.LAUNCHES}
        meshed = [e for e in app.registry.entities() if app.registry.has(e, c.MeshSurface)]
        for rec, e in zip(solves, meshed):
            rec["entity"] = int(e)
        log(f"[viewer] first strike {first_s:.3f} s, of which the solves "
            f"{sum(r['s'] for r in solves):.3f} s; per entity: " + json.dumps(solves)
            + f"; solve progress: {json.dumps(app.solve_progress)} ({card})")
        assert st["selected"] == block and st["struck"] and st["has_audio"], st["audio"]
        assert launched == {"impact": 3, "coupled": 0}, f"kernel launches {launched}"
        checked = {kind: parity[kind]["blocks"] for kind in parity}
        assert checked == launched, f"checked blocks {checked} against launches {launched}"
        audio = app._last_audio
        assert audio.shape == (48_128,) and np.isfinite(audio).all(), "strike not finite"
        assert np.abs(audio).max() > 0, "the strike is silent"
        obj = app._synth_objects[block]
        freqs = np.asarray(app._synth_results[obj].modes.freqs, np.float64)
        wave = app.waveform()
        assert wave["available"], wave
        peaks = np.asarray(wave["peaks_hz"])
        assert (np.abs(peaks[:, None] - freqs[None, :]).min(1) <= 16.0).all(), \
            f"spectrum peaks {peaks.tolist()} off the block's modes {np.round(freqs, 1).tolist()}"
        bank = app.audio_state()
        log(f"[viewer] strike on block {block} (bank {bank['bank_objects']}x{bank['bank_modes']}):"
            f" impact launches {launched['impact']}, coupled {launched['coupled']}; each block "
            f"against the plain version on host copies of its inputs: "
            + json.dumps(parity["impact"]) + f"; audio peak {float(np.abs(audio).max()):.4e}, "
            f"spectrum peaks {peaks.tolist()} Hz on the block's modes "
            f"{np.round(freqs[:6], 1).tolist()} Hz")
        app.frame_png()  # the repaint a click makes first, out of the strike's wall
        impact.LAUNCHES = 0
        t0 = time.perf_counter()
        app.handle({"type": "click", "x": x, "y": y})
        sync()
        second_s = time.perf_counter() - t0
        assert impact.LAUNCHES == 3 and coupled.LAUNCHES == 0, (impact.LAUNCHES, coupled.LAUNCHES)
        verdict = app.verify()
        assert verdict["byte_exact"], verdict
        log(f"[viewer] second strike {second_s * 1e3:.1f} ms with the frame cached (3 impact "
            f"launches, no solve, not checked against the plain version); session replays "
            f"byte-exact ({card})")

        # 5. the edit command as a fresh process, the click pixel from a fresh app's view
        if edit_process:
            fresh = ViewerApp(import_gltf(glb), w, h, session_root=tmp / "fresh", device=device)
            fresh.handle({"type": "orbit", "dx": 8, "dy": 0})
            edit_subprocess(device, card, glb, tmp, size, block, projected_center(fresh, block))
    return {kind: {"launches": launched[kind], **parity[kind]} for kind in launched}


# ---- phase l: the multi-device layer (torch.distributed, one process per rank) ----

MULTICHIP_TOL = {"impact": 2e-5, "coupled": 5e-5}  # x peak: phase 3's and phase a's
VOICE_CARRIES = ("age", "prev_height", "relief_mean", "penetration", "primed", "active", "obj")


def assert_spectra_match(fa, fb, rtol_single=2e-9, rtol_cluster=1e-5, rtol_cluster_mean=2e-9):
    """tests/test_parallel.py:_assert_spectra_match (that module imports JAX), unchanged:
    isolated eigenvalues within rtol_single; a near-degenerate cluster (relative gap below
    rtol_cluster) by its mean within rtol_cluster_mean, each member inside its span."""
    fa = np.asarray(fa, np.float64)
    fb = np.asarray(fb, np.float64)
    assert fa.shape == fb.shape, (fa.shape, fb.shape)
    n = fa.size
    scale = np.maximum(np.abs(fa), np.abs(fb)) + 1e-300
    gaps = np.abs(np.diff(fa)) / np.maximum(scale[1:], 1e-300)
    edges = np.concatenate([[0], np.where(gaps >= rtol_cluster)[0] + 1, [n]])
    for s, e in zip(edges[:-1], edges[1:]):
        if e - s == 1:
            np.testing.assert_allclose(fb[s], fa[s], rtol=rtol_single)
        else:
            ma, mb = fa[s:e].mean(), fb[s:e].mean()
            assert abs(mb - ma) <= rtol_cluster_mean * max(abs(ma), 1e-300), (
                f"cluster [{s}:{e}] mean mismatch: {ma!r} vs {mb!r}")
            width = fa[s:e].max() - fa[s:e].min() + 2 * rtol_cluster * abs(ma)
            assert np.all(np.abs(fb[s:e] - ma) <= width), (
                f"cluster [{s}:{e}] member outside span: {fa[s:e]} vs {fb[s:e]}")


def multichip_rank(device, result) -> dict:
    """One rank of phase l: the bench box solved element-sharded over a tp axis of every
    rank, then the 64-object impact second and the sustained second object-sharded over a dp
    axis of every rank, each render's kernel launches counted from 0 just before it."""
    import torch
    import torch.distributed as dist

    from mesheditor_tpu_torch import bench, mesh2modes
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.parallel import make_mesh, sharding
    from mesheditor_tpu_torch.synth import coupled, impact

    world = dist.get_world_size()
    tp = make_mesh(world, ("tp",), device=device)
    dp = make_mesh(world, ("dp",), device=device)
    mesh, cfg, excite = bench.bench_box()
    sharding.ALL_REDUCES = sharding.ALL_REDUCE_BYTES = sharding.BROADCASTS = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, mesh=tp)
    torch.cuda.synchronize()
    out = {"rank": dist.get_rank(), "device": str(device), "solve": {
        "seconds": time.perf_counter() - t0, "report": res.profile.report(),
        "dofs": res.profile.dofs, "num_modes": res.modes.num_modes,
        "f1": float(res.modes.freqs[0]) if res.modes.num_modes else 0.0,
        "iterations": res.profile.restarts, "eigenvalues": res.summary.eigenvalues,
        "shapes": res.modes.shapes,
        "all_reduces": sharding.ALL_REDUCES, "all_reduce_bytes": sharding.ALL_REDUCE_BYTES,
        "broadcasts": sharding.BROADCASTS}}

    impact.LAUNCHES = coupled.LAUNCHES = 0
    audio = bench.render_main(result, device, mesh=dp)
    out["impact"] = {"audio": audio, "launches": (impact.LAUNCHES, coupled.LAUNCHES)}

    synth, voices = sustained_scene(result, device, mesh=dp)
    impact.LAUNCHES = coupled.LAUNCHES = 0
    sustained, walls = sustained_render(synth, voices)
    launches = (impact.LAUNCHES, coupled.LAUNCHES)
    table = synth.voices.to_numpy()
    out["sustained"] = {"audio": sustained, "launches": launches, "walls": walls,
                        "voices": len(voices), "objects": (synth.shard.lo, synth.shard.hi),
                        "carries": {f: table[f] for f in VOICE_CARRIES}}
    return out


def _noop_rank(device):
    return str(device)


def check_multichip(name: str, ranks: list, result, refs: dict, card: str) -> dict:
    """Hold every rank of one phase-l run to the unsharded card runs: the solve's modes, f1
    and spectrum, each render's kernel launches (both kernels on every rank) and its mix
    within the kernel's tolerance of the unsharded mix, the voice table equal on every
    rank. Prints what it checked; returns {kernel: (launches, max error / peak)}."""
    stats = {"impact": [0, 0.0], "coupled": [0, 0.0]}
    for r in ranks:
        s = r["solve"]
        assert s["dofs"] == 44_289 and s["num_modes"] == 250, (name, r["rank"], s["dofs"],
                                                               s["num_modes"])
        assert abs(s["f1"] - F1_HZ) / F1_HZ < 1e-4, (name, r["rank"], s["f1"])
        assert_spectra_match(result.summary.eigenvalues, s["eigenvalues"])
        assert np.array_equal(s["eigenvalues"], ranks[0]["solve"]["eigenvalues"]), \
            f"{name}: rank {r['rank']}'s eigenvalues differ from rank 0's"
        shape_diff = float(np.abs(s["shapes"] - ranks[0]["solve"]["shapes"]).max())
        log(f"[multichip] {name} rank {r['rank']} ({r['device']}) solve {s['seconds']:.2f} s, "
            f"{s['iterations']} iterations, {s['num_modes']} modes, f1 {s['f1']:.4f} Hz, "
            f"spectrum in the band of the unsharded solve; {s['all_reduces']} all_reduces "
            f"({s['all_reduce_bytes'] / 1e9:.3f} GB from this rank), {s['broadcasts']} "
            f"broadcasts; mode shapes off rank 0's by {shape_diff:.3e}; {s['report']} ({card})")
        for kernel, key, launched in (("impact", "impact", 0), ("coupled", "sustained", 1)):
            got = np.asarray(r[key]["audio"], np.float64)
            want = np.asarray(refs[key], np.float64)
            peak = float(np.abs(want).max())
            err = float(np.abs(got - want).max()) / peak
            launches = r[key]["launches"][launched]
            assert got.shape == want.shape and np.isfinite(got).all(), (name, key)
            assert launches > 0, f"{name}: rank {r['rank']} launched no {kernel} kernel"
            assert err < MULTICHIP_TOL[kernel], \
                f"{name}: rank {r['rank']} {key} off the unsharded render by {err:.3e} x peak"
            stats[kernel][0] += launches
            stats[kernel][1] = max(stats[kernel][1], err)
        sus = r["sustained"]
        assert sus["launches"] == (0, 94), (name, r["rank"], sus["launches"])
        for f in VOICE_CARRIES:
            assert np.array_equal(sus["carries"][f], ranks[0]["sustained"]["carries"][f]), \
                f"{name}: rank {r['rank']}'s voice {f} differs from rank 0's"
        walls = sus["walls"]
        log(f"[multichip] {name} rank {r['rank']} objects {sus['objects']}: impact second "
            f"launches {r['impact']['launches']}; sustained second {sus['voices']} voices, "
            f"launches {sus['launches']}, per-block wall median {np.median(walls):.3f} ms, "
            f"largest {np.max(walls):.3f} ms against the {BLOCK_DEADLINE_MS:.3f} ms deadline; "
            f"voice table equal on every rank ({card})")
    log(f"[multichip] {name}: impact {stats['impact'][1]:.3e} x peak, coupled "
        f"{stats['coupled'][1]:.3e} x peak off the unsharded card renders")
    return stats


def multichip_phase(device, card: str, result=None) -> dict:
    """Phase l: the multi-device layer on the card(s). l1: a mesh of every card under NCCL
    (one rank a card; on a one-card machine a one-rank mesh that still makes every NCCL
    call). l2: two ranks sharing cuda:0 under gloo (real cross-rank sums): the dry run, then
    the bench box at tp = 2 and the two renders at dp = 2. Both are held to the unsharded
    solve `result` (phase 5's; solved here when None) and to its unsharded card renders.
    Returns {kernel: (launches, max error / peak)} over both."""
    import torch

    from mesheditor_tpu_torch import bench, mesh2modes
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.parallel.dryrun import dryrun_multichip
    from mesheditor_tpu_torch.parallel.launch import spawn

    n_cards = torch.cuda.device_count()
    try:
        spawn(_noop_rank, n_cards + 1, device=device, backend="nccl")
    except ValueError as ex:
        log(f"[multichip] NCCL with {n_cards + 1} ranks on {n_cards} cards refused: {ex}")
    else:
        raise AssertionError("NCCL with more ranks than cards was not refused")

    if result is None:
        mesh, cfg, excite = bench.bench_box()
        result = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, device=device)
    synth, voices = sustained_scene(result, device)
    refs = {"impact": bench.render_main(result, device),
            "sustained": sustained_render(synth, voices)[0]}

    t0 = time.perf_counter()
    l1 = spawn(multichip_rank, n_cards, device=device, backend="nccl", args=(result,))
    log(f"[multichip] l1: {n_cards} rank(s) under NCCL in {time.perf_counter() - t0:.1f} s")
    stats = check_multichip("l1 nccl", l1, result, refs, card)

    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device=device, backend="gloo")
    assert all(np.isfinite(r["out"]).all() and r["coupled_launches"] == 1 for r in dry), \
        [(r["coupled_launches"], r["rms"]) for r in dry]
    log(f"[multichip] l2 dry run, 2 ranks on cuda:0 under gloo, in "
        f"{time.perf_counter() - t0:.1f} s; coupled launches "
        f"{[r['coupled_launches'] for r in dry]}")
    t0 = time.perf_counter()
    l2 = spawn(multichip_rank, 2, device=device, backend="gloo", args=(result,))
    log(f"[multichip] l2: 2 ranks on cuda:0 under gloo in {time.perf_counter() - t0:.1f} s")
    for kernel, (launches, err) in check_multichip("l2 gloo", l2, result, refs, card).items():
        stats[kernel][0] += launches
        stats[kernel][1] = max(stats[kernel][1], err)
    return stats


# ---- phase m: the bench command and the bench tools ----

IMPACT_TOL = 2e-5  # phase 3's output tolerance for the impact kernel, x peak
BENCH_LAUNCHES = 10  # 3 fused calls each in the warm-up, timed and golden seconds, 1 parity
# render_bench's widest shapes, (objects, modes, voices, impacts), timed on one 512-sample
# block: the most objects, K = 512 over the warp path's 256, 256 voices on one object.
WIDEST = {"impact": ((1024, 64, 0, 16), (256, 200, 0, 256), (1, 512, 0, 4)),
          "coupled": ((256, 200, 256, 0), (1, 200, 256, 0), (1, 512, 4, 0))}


def bench_command(card: str) -> dict:
    """m1: `python -m mesheditor_tpu_torch bench` as a fresh process on the card: its report
    line (the reference's metric and keys), its detail (the bench box's and the torus's
    answers, the golden band, kernel parity within phase 3's impact tolerance) and the
    impact kernel's launches it printed. Returns the detail with the launches and wall."""
    import re

    from mesheditor_tpu_torch import bench

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SOLVE_LOG_CODE, str(REPO), "mesheditor_tpu_torch",
                           "bench"], cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, f"bench exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    detail = json.loads(proc.stderr.strip().splitlines()[-1])
    solve_lines(proc.stderr, "[bench] m1", card)
    assert list(report) == ["metric", "value", "unit", "vs_baseline"], report
    assert report["metric"] == bench.METRIC and report["unit"] == "x_realtime", report
    assert detail["dofs"] == 44_289 and detail["modes"] == 250, detail
    assert abs(detail["f1_hz"] - F1_HZ) / F1_HZ < 1e-4, detail["f1_hz"]
    band = bench.RMS_BAND
    assert band[0] <= detail["golden_render_rms"] <= band[1], detail["golden_render_rms"]
    assert detail["kernel_parity"] < IMPACT_TOL, detail["kernel_parity"]
    assert detail["cdt_dofs"] == TORUS_DOFS, detail["cdt_dofs"]
    assert abs(detail["cdt_f1_hz"] - TORUS_F1_HZ) / TORUS_F1_HZ < 1e-4, detail["cdt_f1_hz"]
    assert detail["card"] == card, (detail["card"], card)
    launches = int(re.search(r"impact kernel launches: (\d+)", proc.stderr).group(1))
    assert launches == BENCH_LAUNCHES, f"bench launched the impact kernel {launches} times"
    for line in proc.stderr.strip().splitlines()[:-1]:
        if not line.startswith("[solve] "):
            log(f"[bench] | {line}")
    log(f"[bench] m1 `python -m mesheditor_tpu_torch bench` ({wall:.1f} s as a process): "
        f"{json.dumps(report)}; impact launches {launches}; detail {json.dumps(detail)}")
    return {**detail, "launches": launches, "wall_s": wall, "value": report["value"]}


@contextlib.contextmanager
def kernel_args():
    """While open, {"impact": ..., "coupled": ...}: the arguments of the latest call of
    each kernel's wrapper (impact.resonate, coupled.resonate_coupled)."""
    from mesheditor_tpu_torch.synth import coupled, impact

    seen: dict = {}
    inner = impact.resonate, coupled.resonate_coupled

    def recorded(kind, fn):
        def call(*args):
            seen[kind] = args
            return fn(*args)

        return call

    impact.resonate = recorded("impact", inner[0])
    coupled.resonate_coupled = recorded("coupled", inner[1])
    try:
        yield seen
    finally:
        impact.resonate, coupled.resonate_coupled = inner


def time_widest(kind: str, shape, card: str) -> dict:
    """One 512-sample block of render_bench's scene `shape` on the card, its kernel call's
    arguments captured: the kernel's device time (CUDA events over back-to-back launches of
    the bound C entry), the plain version's host-clock time on the same card tensors,
    max |kernel - plain| of the mix and the bound from the call's shapes."""
    import torch

    from mesheditor_tpu_torch.scripts import render_bench as rb
    from mesheditor_tpu_torch.synth import coupled, impact

    synth, voices = rb.scene(*shape, device="cuda")
    with kernel_args() as seen:
        synth.publish_voices(voices)
        synth.render(rb.BLOCK)
    torch.cuda.synchronize()
    args = seen[kind]
    if kind == "impact":
        mix_k = impact.resonate(*args)[0]
        mix_p = impact._resonate_plain(*args)[0]
        ms = event_ms(impact._bind(*args)[0])
        plain_ms = median_ms(lambda: impact._resonate_plain(*args), torch.cuda.synchronize,
                             reps=3)
        n_obj, n_modes = args[0].shape
        work = impact_flops_bytes(n_obj, n_modes, args[3].shape[0], rb.BLOCK)
        plan = None
    else:
        order, offsets = coupled._group_voices(args[12], args[0].shape[0], args[13])
        mix_k = coupled.resonate_coupled(*args)[0]
        mix_p = coupled._resonate_coupled_plain(*args[:13], order, offsets)[0]
        ms = event_ms(coupled._bind(*args)[0])
        plain_ms = median_ms(
            lambda: coupled._resonate_coupled_plain(*args[:13], order, offsets),
            torch.cuda.synchronize, reps=3)
        work = coupled_flops_bytes(args, rb.BLOCK)
        plan = coupled.coupled_plan(args[0].shape[1], args[7].shape[0], args[13])
    peak = max(float(mix_p.abs().max()), 1e-30)
    err = float((mix_k - mix_p).abs().max())
    tol = IMPACT_TOL if kind == "impact" else COUPLED_TOL["out"]
    assert err < tol * peak, f"{kind} {shape}: kernel off plain by {err:.3e} x peak {peak:.3e}"
    bound_ms, bound_by = bound(*work)
    out = {"shape": list(shape), "bank": list(args[0].shape), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err, "plan": plan}
    log(f"[render_bench] {kind} kernel at {shape} (bank {tuple(args[0].shape)}, S=512): "
        f"device {ms:.4f} ms (events), plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}), {bound_ms / ms:.2%} of it, |kernel - plain| {err:.3e} "
        f"(peak {peak:.3e}), plan {plan} ({card})")
    return out


def render_bench_phase(device, card: str, blocks: int = 64, checked_blocks: int = 2) -> dict:
    """m2: render_bench's 21 cases through its main, block-streamed then --fused, the
    counts set to 0 before each run and read after it: every case's timed stretch finite,
    the voice cases through the coupled kernel once a block, the others through the impact
    kernel (once a block streamed, once fused). Then the first `checked_blocks` blocks of
    every case rendered again with each block held against the plain version
    (blocks_against_plain), and each kernel timed at the widest shapes."""
    from mesheditor_tpu_torch.scripts import render_bench as rb
    from mesheditor_tpu_torch.synth import coupled, impact

    out = {"launches": {"impact": 0, "coupled": 0}, "rows": {}}
    for fused in (False, True):
        argv = ["--blocks", str(blocks), "--device", device] + (["--fused"] if fused else [])
        impact.LAUNCHES = coupled.LAUNCHES = 0
        t0 = time.perf_counter()
        rows = rb.main(argv)
        wall = time.perf_counter() - t0
        counts = impact.LAUNCHES, coupled.LAUNCHES
        for row in rows:
            o, k, v, i = row["case"]
            assert row["finite"], f"render_bench {row['case']}: output not finite"
            want = (0, blocks) if v else ((1, 0) if fused else (blocks, 0))
            got = row["impact_launches"], row["coupled_launches"]
            assert got == want, f"render_bench {row['case']}: launches {got}, not {want}"
        out["launches"]["impact"] += counts[0]
        out["launches"]["coupled"] += counts[1]
        out["rows"]["fused" if fused else "streamed"] = rows
        log(f"[render_bench] m2 {'fused' if fused else 'streamed'}, {blocks} blocks: "
            f"{len(rows)} cases finite in {wall:.1f} s, impact launches {counts[0]}, "
            f"coupled launches {counts[1]} (with the warm-up calls) ({card})")

    with blocks_against_plain() as stats:
        for case in rb.CASES:
            synth, voices = rb.scene(*case, device=device)
            for _ in range(checked_blocks):
                synth.publish_voices(voices)
                synth.render(rb.BLOCK)
            if voices:
                o, k, v, i = case
                plan = coupled.coupled_plan(synth.params.coeff_re.shape[1], -(-i // o),
                                            -(-v // o))
                log(f"[render_bench] {case}: coupled plan {plan['path']} "
                    f"({plan['threads_per_cta']} threads a CTA)")
    for kind in ("impact", "coupled"):
        st = stats[kind]
        assert st["blocks"] == checked_blocks * sum(
            (c[2] > 0) == (kind == "coupled") for c in rb.CASES), (kind, st)
        log(f"[render_bench] {kind}: the first {checked_blocks} blocks of each case held "
            f"against the plain version: " + json.dumps(st))
    out["checked"] = stats
    out["widest"] = {kind: [time_widest(kind, shape, card) for shape in shapes]
                     for kind, shapes in WIDEST.items()}
    return out


def solve_paths() -> tuple[int, int, dict]:
    """The device and host solves so far, and the device answers by exit."""
    from mesheditor_tpu_torch.solve import lobpcg

    return lobpcg.DEVICE_SOLVES, lobpcg.HOST_SOLVES, dict(lobpcg.DEVICE_EXITS)


def bench_phase(device, card: str, blocks: int = 64) -> dict:
    """Phase m: the bench command (m1) and the bench tools (m2 render_bench, m3
    edit_loop_bench, m4 cdt_bench at their defaults, m5 realimpact_batch with --devices 1
    over a two-object corpus written here). Returns each kernel's launches and checks."""
    from mesheditor_tpu_torch.scripts import cdt_bench, edit_loop_bench, realimpact_batch

    t_phase = time.perf_counter()
    m1 = bench_command(card)
    m2 = render_bench_phase(device, card, blocks=blocks)

    before = solve_paths()
    t0 = time.perf_counter()
    with solve_log("[edit_loop] m3", card):
        loop = edit_loop_bench.main(["--device", device])
    after = solve_paths()
    rescaled = loop["rescaled"]
    assert rescaled is not None and np.isfinite(rescaled.freqs).all()
    assert loop["cold"].modes.num_modes > 0 and loop["warm"].modes.num_modes > 0
    log(f"[edit_loop] m3 in {time.perf_counter() - t0:.1f} s: cold {loop['cold_s']:.3f} s "
        f"({loop['cold'].profile.restarts} iterations, {loop['cold'].profile.dofs} dofs), warm "
        f"{loop['warm_s']:.3f} s ({loop['warm'].profile.restarts} iterations), rescale "
        f"{loop['rescale_s'] * 1e3:.3f} ms, f1 {float(rescaled.freqs[0]):.4f} Hz against the "
        f"printed closed form f1 x sqrt(0.8 / 1.3) {loop['closed_form_f1']:.4f}; device solves "
        f"{after[0] - before[0]}, host solves {after[1] - before[1]} ({card})")

    t0 = time.perf_counter()
    with solve_log("[cdt_bench] m4", card):
        cdt = cdt_bench.main(["--device", device])
    assert cdt["modes"] > 0 and np.isfinite(cdt["f1_hz"]), cdt
    log(f"[cdt_bench] m4 in {time.perf_counter() - t0:.1f} s: answered by the {cdt['path']} "
        f"path, {cdt['iters']} iterations, {cdt['dofs']} dofs, {cdt['modes']} modes ({card})")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        root = Path(tmp)
        write_realimpact_scan(root)
        write_realimpact_scan(root, name="12_GlassGoblet", scale=(0.08, 0.1, 0.08))
        t0 = time.perf_counter()
        with solve_log("[realimpact_batch] m5", card):
            rows, mix = realimpact_batch.main([str(root), "--devices", "1", "--device", device])
    assert [r["object"] for r in rows] == ["GlassGoblet", "BowlCeramic"], rows
    assert all(r["modes"] > 0 and r["f1_hz"] > 0 for r in rows), rows
    assert mix.shape == (512,) and np.isfinite(mix).all() and np.abs(mix).max() > 0
    log(f"[realimpact_batch] m5 in {time.perf_counter() - t0:.1f} s: "
        + "; ".join(f"{r['object']} ({r['material']}) {r['dofs']} dofs, {r['modes']} modes, "
                    f"f1 {r['f1_hz']:.1f} Hz, {r['solve_s']} s" for r in rows)
        + f"; sharded mix peak {np.abs(mix).max():.3e} over 1 rank "
        f"({'NCCL' if device == 'cuda' else 'gloo'}) ({card})")
    log(f"[bench] phase m in {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"m1": m1, "m2": m2, "edit_loop": loop, "cdt": cdt, "corpus": rows}


# ---- phase n: the scanned-object regime ----

BENDING_BL = (4.73004074, 7.85320462, 10.9956078)  # free-free (beta L)_i, test_modal_solver
SNAPSHOT_FIXTURE = REPO / "tests" / "fixtures" / "tet_corpus_snapshot.txt"
SHELL_PARITY = 1e-3  # tests/test_thin_shell_parity.py: frequencies within 0.1% of scipy
# The JAX package's scripts/realimpact_harness.py at its defaults on the double that
# make_realimpact_double writes at bbox/28 (CPU): each impact's f0 and partials matched of
# 8, mean score 0.325. The recording's top 8 peaks at listener 263 (750 mm) include
# partials under its -60 dB noise floor, so no faithful port scores higher on this double.
HARNESS_F0_HZ = (942.0, 935.8, 942.0, 942.0, 942.0)
HARNESS_MATCHES = (4, 3, 2, 2, 2)
HARNESS_TET_RESOLUTION = 28  # the harness's default lattice, bbox / 28
HARNESS_LAUNCHES = 5 * 6  # 5 impacts, 2 s each in fused calls of 16,384 samples


def _ellipsoid_shell():
    from mesheditor_tpu_torch.mesh import icosphere_surface, shell_surface

    pts, tris = icosphere_surface(2)
    return shell_surface(pts * np.array([0.06, 0.04, 0.02]), tris, 0.0015)


def thin_shells(full: bool) -> list:
    """tests/test_thin_shell_parity.py's shells as (name, surface, modes compared + 6): the
    5%-wall bowl, the 4 mm plate and the 2.5%-wall bowl, and with `full` the ellipsoid shell
    and the noisy scanned bowl (the JAX file's other slow cases)."""
    from mesheditor_tpu_torch.mesh import bowl_surface, cylinder_surface

    shells = [("bowl 5% wall", lambda: bowl_surface(0.06, 0.003, 8, 24), 14),
              ("plate 4 mm", lambda: cylinder_surface(0.09, 0.004, 32), 12),
              ("bowl 2.5% wall", lambda: bowl_surface(0.06, 0.0015, 12, 40), 16)]
    if full:
        shells += [("ellipsoid shell", _ellipsoid_shell, 12),
                   ("noisy scanned bowl",
                    lambda: bowl_surface(0.06, 0.003, 12, 40, noise=0.15, seed=7), 12)]
    return shells


def bar_families(modes, bar_dims, nx) -> dict:
    """tests/test_modal_solver.py's `classify`: each mode's family by where its kinetic
    energy lies (axial; a rigid rotation of each cross-section, torsion; lateral, bending
    along y, z or both), as {family: [frequency, ...]}."""
    length, width, thickness = bar_dims
    pos = np.asarray(modes.positions, dtype=np.float64)
    shapes = np.asarray(modes.shapes, dtype=np.float64)  # (points, modes, 3)
    ry = pos[:, 1] - width / 2
    rz = pos[:, 2] - thickness / 2
    slice_id = np.rint(pos[:, 0] * nx / length).astype(int)
    families = {}
    for k in range(modes.num_modes):
        u = shapes[:, k, :]
        total = (u**2).sum()
        if total <= 0:
            families.setdefault("other", []).append(modes.freqs[k])
            continue
        axial = (u[:, 0] ** 2).sum()
        lateral_y = (u[:, 1] ** 2).sum()
        lateral_z = (u[:, 2] ** 2).sum()
        rotation = 0.0
        for s in np.unique(slice_id):
            m = slice_id == s
            circ = (ry[m] * u[m, 2] - rz[m] * u[m, 1]).sum()
            r2 = (ry[m] ** 2 + rz[m] ** 2).sum()
            if r2 > 0:
                rotation += circ**2 / r2
        if axial / total > 0.85:
            fam = "longitudinal"
        elif rotation / total > 0.85:
            fam = "torsional"
        elif (lateral := lateral_y + lateral_z) / total > 0.6 and rotation / total < 0.5:
            if lateral_y / lateral > 0.8:
                fam = "bending_y"
            elif lateral_z / lateral > 0.8:
                fam = "bending_z"
            else:
                fam = "bending"
        else:
            fam = "other"
        families.setdefault(fam, []).append(float(modes.freqs[k]))
    return families


def bar_theory(dims, material) -> dict:
    """The free-free bar's first closed-form frequencies, Poisson's ratio 0
    (tests/test_modal_solver.py): longitudinal c / 2L; torsional (square section)
    sqrt(G J / (rho Ip)) / 2L with J / Ip = 0.140577 * 6; Euler-Bernoulli bending about the
    thin axis (beta L)_1^2 c r_g / (2 pi L^2), r_g = thickness / sqrt(12)."""
    length, _, thickness = dims
    speed = np.sqrt(material.young_modulus / material.density)
    return {"longitudinal": speed / (2 * length),
            "torsional": np.sqrt(material.lame_mu() / material.density * 0.140577 * 6)
            / (2 * length),
            "bending": BENDING_BL[0] ** 2 * speed * thickness / np.sqrt(12)
            / (2 * np.pi * length ** 2)}


def check_family(name, fem, theory, tol, min_count=1) -> float:
    """tests/test_modal_solver.py's check_family: the first modes of a family each within
    `tol` of theory. Returns the worst |ratio - 1|."""
    count = min(len(fem), len(theory))
    assert count >= min_count, f"{name}: only {count} modes found"
    worst = 0.0
    for i in range(count):
        off = abs(fem[i] / theory[i] - 1.0)
        assert off < tol, f"{name} mode {i}: fem {fem[i]:.1f} vs theory {theory[i]:.1f}"
        worst = max(worst, off)
    return worst


def snapshot_check() -> float:
    """n1: the mesher's structural snapshot, from the port's own build, held to the
    fixture's rows (all but the iso-surface rows, minutes each). Returns the wall."""
    from mesheditor_tpu_torch.scripts.tet_corpus_snapshot import snapshot_lines

    want = [line for line in SNAPSHOT_FIXTURE.read_text().strip().splitlines()
            if not line.startswith("iso_")]
    t0 = time.perf_counter()
    got = list(snapshot_lines(include=lambda n: not n.startswith("iso_")))
    wall_s = time.perf_counter() - t0
    bad = [(g, w) for g, w in zip(got, want) if g != w]
    assert len(got) == len(want) and not bad, \
        f"snapshot: {len(got)} rows against {len(want)}; first differing: {bad[:2]}"
    return wall_s


def solve_path(before) -> str:
    """The path that answered the solves since `before` (solve_paths()); a device answer
    reads "device (<exit>)"."""
    device_n, host_n, exits = solve_paths()
    moved = ",".join(k for k, v in exits.items() if v > before[2][k])
    return "+".join(p for p, n in ((f"device ({moved})", device_n - before[0]),
                                   ("host", host_n - before[1])) if n) or "none"


def start_shell_oracles(shells, tmp: Path) -> list:
    """Each thin shell meshed by the port's mesher, with scipy's shift-invert on its pencil
    started in a process of its own. Returns (name, mesh, modes compared + 6, process, the
    .npy its eigenvalues land in) per shell."""
    from mesheditor_tpu_torch.mesh.cdt import generate_tets_delaunay

    sigma = -((2 * np.pi * 20.0) ** 2)
    cases = []
    for name, surface, nev in shells:
        tm = generate_tets_delaunay(*surface())
        where = tmp / f"oracle_{name.replace(' ', '_').replace('%', 'pct')}"
        where.mkdir()
        cases.append((name, tm, nev, *start_oracle(tm, nev + 10, sigma, where)))
    return cases


@contextlib.contextmanager
def eig_trace(on: bool = True):
    """While open and `on`, the eigensolver's per-iteration trace is switched on
    (MESHEDITOR_TPU_DEBUG_EIG) and taken off standard output: yields the list its lines
    land in (the device engine's `[ortho]` lines, the closure engine's `[eig]` lines); any
    other line printed meanwhile is logged as it was."""
    import io

    lines = []
    if not on:
        yield lines
        return
    env = os.environ.get("MESHEDITOR_TPU_DEBUG_EIG")
    os.environ["MESHEDITOR_TPU_DEBUG_EIG"] = "1"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield lines
    finally:
        if env is None:
            del os.environ["MESHEDITOR_TPU_DEBUG_EIG"]
        else:
            os.environ["MESHEDITOR_TPU_DEBUG_EIG"] = env
        for line in buf.getvalue().splitlines():
            (lines.append if line.startswith(("[ortho]", "[eig] ")) else log)(line)


def trace_summary(lines: list) -> dict:
    """The first and last five `[ortho]` lines of one solve and the settled count of its
    last iteration ("settled/nev"): where a solve that gives up stood."""
    last = lines[-1].split("settled=")[1].split()[0] if lines else None
    return {"lines": len(lines), "first": lines[:5], "last": lines[-5:], "settled_last": last}


TRACED_SHELLS = ("bowl 2.5% wall", "noisy scanned bowl")  # o3: the thin walls that give up


def shells_check(device, card: str, cases) -> list:
    """n2: each thin shell solved on `device` at tests/test_thin_shell_parity.py's
    settings, its lowest modes within 0.1% of its scipy oracle (start_shell_oracles).
    Returns one row per shell; each is printed before it is held to the bar. The shells of
    TRACED_SHELLS are solved with the eigensolver's trace on (phase o3): its first and last
    five lines and the settled count where it stopped are printed and kept in the row."""
    from mesheditor_tpu_torch import SolverConfig, mesh2modes
    from mesheditor_tpu_torch.materials import CERAMIC

    rows = []
    for name, tm, nev, proc, out in cases:
        cfg = SolverConfig(num_modes=nev, num_fem_modes=nev + 6, max_mode_freq=96_000.0)
        excite = tm.points[:: max(tm.points.shape[0] // 4, 1)][:4]
        before = solve_paths()
        t0 = time.perf_counter()
        with eig_trace(name in TRACED_SHELLS) as lines:
            res = mesh2modes(tm, CERAMIC.properties, excite, config=cfg, device=device)
        solve_s = time.perf_counter() - t0
        trace = trace_summary(lines) if name in TRACED_SHELLS else None
        if trace:
            for line in trace["first"] + ["..."] + trace["last"]:
                log(f"[debug] o3 {name} | {line}")
            log(f"[debug] o3 {name}: {trace['lines']} [ortho] lines, settled "
                f"{trace['settled_last']} at the last ({res.profile.restarts} iterations in "
                f"all, {solve_path(before)} answered, {res.modes.num_modes} modes; {card})")
        got = np.asarray(res.modes.freqs)
        k, rel, oracle_s, f_true = 0, float("inf"), float("nan"), None
        if got.size:  # a solve that returned nothing is reported without its oracle
            text, err = proc.communicate(timeout=1800)
            assert proc.returncode == 0, \
                f"{name}: the scipy oracle exited {proc.returncode}:\n{err}"
            oracle_s = float(text.split()[-1])
            f_true = np.sqrt(np.maximum(np.load(out), 0))
            f_true = f_true[f_true > 2 * np.pi * 20.0] / (2 * np.pi)
            k = min(got.size, f_true.size, nev - 6)
            rel = float((np.abs(got[:k] - f_true[:k]) / f_true[:k]).max())
        proc.kill()
        row = {"shell": name, "tets": int(tm.tets.shape[0]), "dofs": res.profile.dofs,
               "iterations": res.profile.restarts, "path": solve_path(before),
               "modes": res.modes.num_modes, "f1_hz": float(got[0]) if got.size else 0.0,
               "max_rel_err": rel, "solve_s": solve_s, "oracle_s": oracle_s,
               "stages": res.profile.report(), "trace": trace,
               "oracle_hz": None if f_true is None else f_true.tolist()}
        log(f"[scans] {name}: {row['tets']} tets, {row['dofs']} dofs, answered by "
            f"{row['path']} in {row['iterations']} iterations, {row['modes']} modes, f1 "
            f"{row['f1_hz']:.2f} Hz, lowest {k} within {rel:.3e} of scipy; solve "
            f"{solve_s:.3f} s ({card}), scipy {oracle_s:.1f} s in a process of its own; "
            f"{row['stages']}")
        assert rel < SHELL_PARITY, f"{name}: {rel:.3e} off scipy ({got.size} modes)"
        rows.append(row)
    return rows


def bars_check(device, card: str) -> dict:
    """n3: tests/test_modal_solver.py's slow bar oracles on `device`: the reference's
    20x4x4 square bar (longitudinal 1%, torsional 5%, bending 10%), the thin 30x5x1 bar
    (longitudinal 1%, bending about the thin axis 5%), and the warm start (a seeded re-solve
    in a nearby material takes fewer restarts, f1 moves by sqrt(1.1) within 5%)."""
    from mesheditor_tpu_torch import SolverConfig, mesh2modes
    from mesheditor_tpu_torch.mesh import bar_tets
    from mesheditor_tpu_torch.solve.mesh2modes import SolveReuse
    from mesheditor_tpu_torch.types import AcousticMaterialProperties

    out = {}
    cfg = SolverConfig(num_modes=30, num_fem_modes=45, max_mode_freq=48_000.0)
    for name, dims, res, mat in (
            ("square bar 20x4x4", (0.3, 0.05, 0.05), (20, 4, 4),
             AcousticMaterialProperties(1000, 1e7, 0.0)),
            ("thin bar 30x5x1", (0.3, 0.05, 0.01), (30, 5, 1),
             AcousticMaterialProperties(1000, 1e9, 0.0))):
        mesh = bar_tets(*dims, *res)
        before = solve_paths()
        t0 = time.perf_counter()
        r = mesh2modes(mesh, mat, mesh.points, config=cfg, device=device)
        solve_s = time.perf_counter() - t0
        fam = bar_families(r.modes, dims, res[0])
        th = bar_theory(dims, mat)
        bending = sorted(fam.get("bending", []) + fam.get("bending_y", [])
                         + fam.get("bending_z", []))
        if res[2] > 1:
            worst = {
                "longitudinal": check_family(name, sorted(fam.get("longitudinal", [])),
                                             [th["longitudinal"] * n for n in (1, 2, 3)],
                                             0.01, 2),
                "torsional": check_family(name, sorted(fam.get("torsional", [])),
                                          [th["torsional"] * n for n in (1, 2)], 0.05, 2),
                "bending": check_family(name, bending[:2], [th["bending"]] * 2, 0.10, 2)}
        else:
            worst = {
                "longitudinal": check_family(name, sorted(fam.get("longitudinal", [])),
                                             [th["longitudinal"]], 0.01),
                "bending_z": check_family(name, sorted(fam.get("bending_z", [])),
                                          [th["bending"]], 0.05)}
        out[name] = {"dofs": r.profile.dofs, "iterations": r.profile.restarts,
                     "path": solve_path(before), "solve_s": solve_s, "worst": worst}
        log(f"[scans] {name}: {r.profile.dofs} dofs, answered by {out[name]['path']} in "
            f"{r.profile.restarts} iterations, {solve_s:.3f} s ({card}); worst |fem/theory - "
            f"1| by family: " + ", ".join(f"{k} {v:.4f}" for k, v in worst.items()))
    mat = AcousticMaterialProperties(1000, 1e7, 0.0)
    mesh = bar_tets(0.2, 0.04, 0.04, 5, 2, 2)
    wcfg = SolverConfig(num_modes=15, num_fem_modes=15)
    cold = mesh2modes(mesh, mat, mesh.points[:4], config=wcfg,
                      reuse=SolveReuse(keep_basis=True), device=device)
    assert cold.basis is not None, "the cold solve kept no basis"
    warm = mesh2modes(mesh, AcousticMaterialProperties(1000, 1.1e7, 0.02), mesh.points[:4],
                      config=wcfg, reuse=SolveReuse(seed_basis=cold.basis), device=device)
    assert warm.modes.num_modes > 0, "the warm solve returned no mode"
    assert warm.profile.restarts < max(cold.profile.restarts, 4), \
        f"warm {warm.profile.restarts} restarts, cold {cold.profile.restarts}"
    ratio = warm.modes.freqs[0] / cold.modes.freqs[0] / np.sqrt(1.1)
    assert 0.95 < ratio < 1.05, f"warm f1 moved by {ratio:.4f} x sqrt(1.1)"
    out["warm start"] = {"cold": cold.profile.restarts, "warm": warm.profile.restarts,
                         "ratio": float(ratio)}
    log(f"[scans] warm start: cold {cold.profile.restarts} restarts, warm "
        f"{warm.profile.restarts}, f1 ratio / sqrt(1.1) {ratio:.4f}")
    return out


# The harness in a process of its own, run as `python -m` runs it, with the blocks of its
# first strike also rendered by the plain version on host copies of their arguments.
HARNESS_CODE = """
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
limit = int(sys.argv[2])
sys.argv = ["realimpact_harness"] + sys.argv[3:]
with chip_smoke.blocks_against_plain(limit=limit) as stats, chip_smoke.solve_log():
    runpy.run_module("mesheditor_tpu_torch.scripts.realimpact_harness", run_name="__main__")
print("[checked] " + json.dumps(stats["impact"]))
"""


def harness_check(device, card: str, tmp: Path, double, tet_resolution: int) -> dict:
    """n4: `python -m mesheditor_tpu_torch.scripts.realimpact_harness` at its defaults (a
    rehearsal off the card passes a coarser `tet_resolution`) on the scan double that
    `double` (the make_realimpact_double process) writes under `tmp`.
    Every impact has the f0 and the partial matches that the JAX package's script gives
    on this double (HARNESS_F0_HZ within 0.1 Hz, HARNESS_MATCHES), the impact kernel
    rendered every strike (30 launches), the first strike's blocks agree with the plain
    version within 2e-5 x peak, and every wav pair reads back."""
    from mesheditor_tpu_torch.io import read_wav
    from mesheditor_tpu_torch.io.realimpact import SAMPLE_RATE

    text, err = double.communicate(timeout=900)
    assert double.returncode == 0, f"make_realimpact_double exited {double.returncode}:\n{err}"
    log(f"[scans] scan double: {text.strip().splitlines()[1].strip()} (scipy at bbox/"
        f"{tet_resolution}), written in {float(text.split()[-1]):.1f} s")
    args = [] if tet_resolution == HARNESS_TET_RESOLUTION else [
        "--tet-resolution", str(tet_resolution)]
    out_dir = tmp / "harness_out"
    first_strike = -(-int(np.ceil(2.0 * SAMPLE_RATE / 512)) * 512 // 16_384)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", HARNESS_CODE, str(REPO), str(first_strike),
         "--dataset", str(tmp / "double"), "--out", str(out_dir), "--device", device, *args],
        capture_output=True, text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    assert proc.returncode == 0, f"the harness exited {proc.returncode}:\n{proc.stderr[-3000:]}"
    solve_lines(proc.stderr, "[scans] n4 harness", card)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        log(f"[scans] harness | {line}")
    checked = json.loads(lines[-1].split(" ", 1)[1])
    f0s = [float(line.split("f0=")[1].split("Hz")[0]) for line in lines if "f0=" in line]
    matches = [int(line.split("match ")[1].split("/")[0]) for line in lines if "f0=" in line]
    score = float(next(line for line in lines if line.startswith("mean partial-match"))
                  .split(":")[1])
    launches = int(next(line for line in lines if "impact kernel launches" in line)
                   .split(":")[1])
    solve = next(line for line in lines if line.strip().startswith("solve:")).strip()
    assert len(f0s) == 5 and min(f0s) > 0, f"f0s {f0s}"
    if tet_resolution == HARNESS_TET_RESOLUTION:
        assert np.abs(np.subtract(f0s, HARNESS_F0_HZ)).max() < 0.1, f"f0s {f0s}"
        assert tuple(matches) == HARNESS_MATCHES, f"partials matched {matches}"
    assert launches == HARNESS_LAUNCHES, f"impact launches {launches} != {HARNESS_LAUNCHES}"
    assert checked["blocks"] == first_strike, f"first strike: {checked['blocks']} blocks"
    assert checked["max_rel_err"] < IMPACT_TOL, checked
    wavs = sorted(out_dir.glob("*.wav"))
    assert len(wavs) == 10, [w.name for w in wavs]
    for w in wavs:
        audio, rate = read_wav(w)
        assert rate == SAMPLE_RATE and audio.size > 0 and np.isfinite(audio).all(), w.name
    log(f"[scans] harness: {solve}; f0 {', '.join(f'{f:.1f}' for f in f0s)} Hz; partials "
        f"matched {matches} of 8, mean score {score}; impact launches {launches}; first "
        f"strike {checked['blocks']} blocks within {checked['max_rel_err']:.3e} x peak of the "
        f"plain version; 10 wavs read back; process wall {wall_s:.1f} s ({card})")
    return {"launches": launches, "score": score, "f0_hz": f0s, "matches": matches,
            "solve": solve,
            "process_s": wall_s, "checked": checked}


def scans_phase(device, card: str, full: bool = False,
                tet_resolution: int = HARNESS_TET_RESOLUTION) -> dict:
    """Phase n: the scanned-object regime. The scan double is written in a process of its
    own from the start (its scipy solve and its 1 GiB of recordings take about a minute),
    and every shell's scipy oracle too, beside n1 (the mesher snapshot), n2 (the thin
    shells against scipy) and n3 (the bar oracles); then n4, the harness on the double.
    `full` adds the ellipsoid shell and the noisy bowl, solved last. (A rehearsal off the
    card passes a coarser `tet_resolution` for the double and the harness.)"""
    t_phase = time.perf_counter()
    shells = thin_shells(full)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scans_") as name:
        tmp = Path(name)
        double = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, time; sys.path.insert(0, sys.argv[1]); t0 = time.perf_counter()\n"
             "from mesheditor_tpu_torch.scripts.make_realimpact_double import main\n"
             "main(sys.argv[2:]); print(time.perf_counter() - t0)",
             str(REPO), str(tmp / "double"), "--tet-resolution", str(tet_resolution)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        cases = []
        try:
            cases = start_shell_oracles(shells, tmp)
            snap_s = snapshot_check()
            log(f"[scans] n1 snapshot: the port-built mesher's non-iso rows equal "
                f"{SNAPSHOT_FIXTURE.relative_to(REPO)} in {snap_s:.1f} s")
            with solve_log("[scans]", card):
                rows = shells_check(device, card, cases[:3])
                bars = bars_check(device, card)
            harness = harness_check(device, card, tmp, double, tet_resolution)
            with solve_log("[scans]", card):
                rows += shells_check(device, card, cases[3:])
        finally:
            double.kill()
            for case in cases:
                case[3].kill()
    log(f"[scans] phase n in {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"snapshot_s": snap_s, "shells": rows, "bars": bars, "harness": harness}


# ---- phase o: the debugging surface ----


@contextlib.contextmanager
def kernel_and_debug_routes():
    """While open, every block a ModalSynth renders goes through synth.render_block twice
    on the same arguments: the engine's own call (debug=False, the kernel route; the synth
    keeps its result) and debug=True (the plain recurrence with its traces, on the same
    device). The debug route's mix, state and tables are held to the kernel route's at
    coupled_parity's tolerances on host copies, its traces to their invariants (rm_t's and
    pen_t's last rows are the carries out bit for bit, relief_t is the relief transposed,
    every entry finite). Yields a list with one record a block: both routes' walls (host
    clock, each ending in a sync), the kernel route's launches, the mix peaks and the
    error."""
    import torch

    from mesheditor_tpu_torch.synth import coupled, engine, impact

    real = engine.render_block
    records = []

    def render(*args, **kw):
        counts = coupled.LAUNCHES, impact.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = real(*args, **kw)
        torch.cuda.synchronize()
        kernel_ms = (time.perf_counter() - t0) * 1e3
        launched = coupled.LAUNCHES - counts[0], impact.LAUNCHES - counts[1]
        t0 = time.perf_counter()
        *traced, dbg = real(*args, debug=True, **kw)
        torch.cuda.synchronize()
        debug_ms = (time.perf_counter() - t0) * 1e3
        assert (coupled.LAUNCHES - counts[0], impact.LAUNCHES - counts[1]) == launched, \
            "the debug route launched a kernel"
        name = f"debug block {len(records)}"
        want = [_on_host(t) for t in traced[:3]] + [traced[3].cpu()]
        z_peak = float(max(want[0].z_re.abs().max(), want[0].z_im.abs().max()))
        err, peak = coupled_parity(name, got, want, state_scale=max(
            float(want[3].abs().max()), z_peak))
        assert torch.equal(dbg["rm_t"][-1], dbg["rm_out"]), f"{name}: rm_t[-1] != rm_out"
        assert torch.equal(dbg["pen_t"][-1], dbg["pen_out"]), f"{name}: pen_t[-1] != pen_out"
        assert torch.equal(dbg["relief_t"], dbg["relief"].T), f"{name}: relief_t != relief.T"
        assert all(bool(torch.isfinite(v).all()) for v in dbg.values()), f"{name}: not finite"
        assert all(v.device == traced[3].device for v in dbg.values()), f"{name}: device"
        records.append({"kernel_ms": kernel_ms, "debug_ms": debug_ms,
                        "coupled_launches": launched[0], "impact_launches": launched[1],
                        "peak": peak, "debug_peak": float(traced[3].abs().max()),
                        "max_abs_err": err,
                        "force_peak": float(dbg["force_t"].max()) if dbg["force_t"].numel()
                        else 0.0})
        return got

    engine.render_block = render
    try:
        yield records
    finally:
        engine.render_block = real


def debug_render_check(result, device, card: str, blocks: int = 3, frames: int = 512) -> dict:
    """o1: the first `blocks` blocks of the sustained second (64 objects of the solved box,
    16 bridge voices) through both routes of render_block (kernel_and_debug_routes): every
    block launches the coupled kernel once on its kernel route and nothing on its debug
    route. Then rest_silence's resting contact through both routes: both mixes exactly
    0.0. Returns the walls, launches and errors."""
    from mesheditor_tpu_torch.synth import coupled

    synth, voices = sustained_scene(result, device)
    with kernel_and_debug_routes() as records:
        for _ in range(blocks):
            synth.publish_voices(voices)
            synth.render(frames)
    launches = sum(r["coupled_launches"] for r in records)
    assert launches == blocks and all(r["impact_launches"] == 0 for r in records), records
    rel = max(r["max_abs_err"] / max(r["peak"], 1e-30) for r in records)
    for i, r in enumerate(records):
        log(f"[debug] o1 block {i}: kernel route {r['kernel_ms']:.3f} ms, debug route "
            f"{r['debug_ms']:.3f} ms (host clock, each to a sync; {card}); mix peak "
            f"{r['peak']:.4e}, |debug - kernel| {r['max_abs_err']:.3e}, largest traced force "
            f"{r['force_peak']:.4e} N")
    before = coupled.LAUNCHES
    with kernel_and_debug_routes() as rest:
        peak = rest_silence(device)
    assert coupled.LAUNCHES == before + 8, "rest scene did not go through the kernel"
    assert peak == 0.0 and all(r["debug_peak"] == 0.0 for r in rest), \
        f"resting contact not silent: kernel {peak!r}, debug {[r['debug_peak'] for r in rest]}"
    log(f"[debug] o1: {blocks} blocks of {frames} (64 objects, 16 voices) through both routes, "
        f"debug within {rel:.3e} x peak of the kernel route (coupled_parity), traces "
        f"consistent; rest silence exactly 0.0 on both routes (8 blocks); kernel route "
        f"median {np.median([r['kernel_ms'] for r in records]):.3f} ms a block, debug route "
        f"{np.median([r['debug_ms'] for r in records]):.3f} ms ({card})")
    return {"launches": launches, "impact_launches": 0, "max_rel_err": rel,
            "kernel_ms": [r["kernel_ms"] for r in records],
            "debug_ms": [r["debug_ms"] for r in records]}


def bench_box_pencil(device) -> dict:
    """The bench box's pencil as mesh2modes builds it, assembled and preconditioned once:
    its element operators, diagonals, AMG, shift, clamped config and pair count."""
    from mesheditor_tpu_torch import bench
    from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                          filter_degenerate, pencil_diagonals)
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.solve.amg import build_amg

    mesh, cfg, _excite = bench.bench_box()
    cfg = cfg.clamp()
    kept = filter_degenerate(mesh.points, mesh.tets)
    quad = build_quad_mesh(kept, mesh.points.shape[0])
    ops = assemble_element_matrices(mesh.points, kept, CERAMIC.properties, quad, device=device)
    sigma = -((2 * np.pi * cfg.min_mode_freq) ** 2)
    kd, md = pencil_diagonals(ops)
    pre = build_amg(mesh.points, kept, quad, ops, kd, md, sigma)
    return {"ops": ops, "kd": kd, "md": md, "pre": pre, "sigma": sigma, "cfg": cfg,
            "nev": min(cfg.num_fem_modes, ops.n_dofs - 1)}


def debug_solve_check(device, card: str) -> dict:
    """o2: the bench box's pencil (assembled and preconditioned once) solved by
    lobpcg_pencil with the trace off, then on, twice: free, and under
    torch.use_deterministic_algorithms. Every element sum adds in a fixed order, so each
    pair must give the same eigenvalues and vectors bit for bit, the free pair too, and the
    two pairs must agree with each other; one `[ortho]` line an iteration. The trace's cost
    is each pair's wall delta, and the free pair's walls are printed beside the flagged
    pair's."""
    import torch

    from mesheditor_tpu_torch.solve.lobpcg import lobpcg_pencil

    box = bench_box_pencil(device)
    ops, pre, sigma, cfg, nev = (box[k] for k in ("ops", "pre", "sigma", "cfg", "nev"))

    def solve(debug):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eig_trace(debug) as lines:
            res = lobpcg_pencil(ops, nev, sigma=sigma, precond=pre, guard=cfg.guard,
                                tol=cfg.tolerance, max_iters=cfg.max_restarts,
                                inner_iters=cfg.inner_iters, small_n=cfg.small_n,
                                host_fallback_n=cfg.host_fallback_n,
                                tol_accept=cfg.tol_accept, debug=debug)
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0, lines

    def differ(a, b):
        return (float(np.abs(a.eigenvalues - b.eigenvalues).max()),
                float((a.eigenvectors - b.eigenvectors).abs().max()))

    off, off_s, quiet = solve(False)
    on, on_s, lines = solve(True)
    free = differ(off, on)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        d_off, d_off_s, d_quiet = solve(False)
        d_on, d_on_s, d_lines = solve(True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert not quiet and not d_quiet, (quiet + d_quiet)[:3]
    for name, a, b in (("free", off, on), ("flagged", d_off, d_on), ("free and flagged", off,
                                                                      d_off)):
        assert np.array_equal(a.eigenvalues, b.eigenvalues), \
            f"the {name} pair's eigenvalues differ by {differ(a, b)[0]:.3e}"
        assert torch.equal(a.eigenvectors, b.eigenvectors), \
            f"the {name} pair's vectors differ by {differ(a, b)[1]:.3e}"
    assert len(lines) == len(d_lines) == on.iterations == d_on.iterations > 0, \
        (len(lines), len(d_lines), on.iterations, d_on.iterations)
    assert d_on.eigenvalues.size == nev
    for line in lines[:2] + ["..."] + lines[-2:]:
        log(f"[debug] o2 | {line}")
    log(f"[debug] o2 bench box ({ops.n_dofs} dofs, {nev} pairs), {off.iterations} iterations, "
        f"{len(lines)} [ortho] lines: free, trace off {off_s:.3f} s / on {on_s:.3f} s "
        f"({on_s - off_s:+.3f} s); under deterministic algorithms off {d_off_s:.3f} s / on "
        f"{d_on_s:.3f} s ({d_on_s - d_off_s:+.3f} s); all four bit-identical in eigenvalues "
        f"and vectors ({card})")
    return {"iterations": off.iterations, "lines": len(lines), "off_s": off_s, "on_s": on_s,
            "deterministic_off_s": d_off_s, "deterministic_on_s": d_on_s,
            "free_pair_differ": free}


def diag_runs(stdout: str) -> list:
    """diag_cdt_solve's output, one dict a run: the run line's wall, f1, iterations and
    dofs, and the `[ortho]` lines printed before it."""
    chunks = stdout.split("--- run ")
    rows = []
    for before, chunk in zip(chunks[:-1], chunks[1:]):
        head = chunk.splitlines()[0]
        fields = dict(f.split("=") for f in head.replace(",", "").split() if "=" in f)
        rows.append({"wall_s": float(head.split(":")[1].split("s")[0]),
                     "f1_hz": float(fields["f1"]), "iterations": int(fields["iterations"]),
                     "dofs": int(fields["dofs"]),
                     "lines": sum(line.startswith("[ortho]") for line in before.splitlines())})
    return rows


def diag_cdt_check(card: str, runs: int = 2) -> dict:
    """o4: `python -m mesheditor_tpu_torch.scripts.diag_cdt_solve 2` as a process on the
    card: exit 0; every run 51,402 dofs, f1 within 1e-4 of 5565.28 Hz, one `[ortho]` line
    an iteration. Returns each run's wall, iterations and f1 and the process wall."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SOLVE_LOG_CODE, str(REPO),
                           "mesheditor_tpu_torch.scripts.diag_cdt_solve", str(runs), "--device",
                           "cuda"], capture_output=True, text=True, timeout=600, cwd=REPO)
    wall_s = time.perf_counter() - t0
    assert proc.returncode == 0, f"diag_cdt_solve exited {proc.returncode}:\n{proc.stderr[-3000:]}"
    solves = solve_lines(proc.stderr, "[debug] o4", card)
    rows = diag_runs(proc.stdout)
    for i, row in enumerate(rows):
        assert row["dofs"] == TORUS_DOFS, row
        assert abs(row["f1_hz"] - TORUS_F1_HZ) / TORUS_F1_HZ < 1e-4, row
        assert row["lines"] == row["iterations"] > 0, row
        log(f"[debug] o4 run {i}: {row['wall_s']:.1f} s, {row['iterations']} iterations "
            f"({row['lines']} [ortho] lines), f1 {row['f1_hz']:.2f} Hz, {row['dofs']} dofs "
            f"({card})")
    assert len(rows) == runs, proc.stdout[-2000:]
    assert [r["iterations"] for r in rows] == [r["iterations"] for r in solves], (rows, solves)
    log(f"[debug] o4 diag_cdt_solve {runs}: process wall {wall_s:.1f} s ({card})")
    return {"runs": rows, "process_s": wall_s}


def debug_phase(device, card: str, result=None) -> dict:
    """Phase o: o1 (render_block's two routes on phase 5's solved box, solved here when
    None), o2 (the trace costs no bit) and o4 (the diag_cdt_solve tool); o3 runs inside
    phase n (TRACED_SHELLS). The coupled kernel's launches in o1 are returned apart from
    every other phase's."""
    t_phase = time.perf_counter()
    with solve_log("[debug]", card):
        if result is None:
            from mesheditor_tpu_torch import bench, mesh2modes
            from mesheditor_tpu_torch.materials import CERAMIC

            mesh, cfg, excite = bench.bench_box()
            result = mesh2modes(mesh, CERAMIC.properties, excite, config=cfg, device=device)
        out = {"o1": debug_render_check(result, device, card),
               "o2": debug_solve_check(device, card)}
    out["o4"] = diag_cdt_check(card)
    log(f"[debug] phase o in {time.perf_counter() - t_phase:.1f} s ({card})")
    return out


# ---- phase p: the general-pencil form (operator callables, the closure engine) ----


PENCIL_BARS = ((8, 2, 2), (24, 4, 4))  # the reference script's bar (1,275 dofs); 11,907 dofs
PENCIL_PARITY = 1e-6  # p1: audible frequencies against scipy's shift-invert
PENCIL_INNER, PENCIL_TOL, PENCIL_BUDGET = 24, 1e-8, 200  # the reference script's settings
CLOSURE_TRACE = re.compile(r"\[eig\] it=(\d+) settled=(\d+)/(\d+) blocker: lam=(\S+) "
                           r"delta=(\S+) rel=(\S+) window=(\S+)$")


def closure_solves() -> int:
    from mesheditor_tpu_torch.solve import lobpcg

    return lobpcg.CLOSURE_SOLVES


def pencil_bars_check(device, card: str) -> list:
    """p1: the port's check_eigensolver.check (the reference's script) on each bar of
    PENCIL_BARS, with Jacobi CG and with the float32 pencil (sparse float32 copies of the
    assembled pencil): answered by the closure engine alone, its panels by the op-count
    rule, every audible frequency within PENCIL_PARITY of scipy, and its own six rigid
    eigenvalues (not exact zeros) under 1e-6 of the first elastic one."""
    import io

    from mesheditor_tpu_torch.scripts.check_eigensolver import check, op_rule

    rows = []
    for res in PENCIL_BARS:
        for f32 in (False, True):
            before, closure_before = solve_paths(), closure_solves()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = check(res, 20, PENCIL_INNER, device=device, f32=f32)
            for line in buf.getvalue().splitlines():
                log(f"[pencil] p1 | {line}")
            assert out["got_hz"] is not None, f"bar {res}, {out['engine']}: empty answer"
            assert closure_solves() == closure_before + 1 and solve_paths() == before, \
                f"bar {res}: not answered by the closure engine alone"
            it = out["iterations"]
            rule = op_rule(it, PENCIL_INNER, it // 25)
            rigid = np.asarray(out["rigid"])
            first = (2 * np.pi * out["got_hz"][0]) ** 2
            log(f"[pencil] p1 bar {'x'.join(map(str, res))} ({out['n_dofs']} dofs, 20 modes, "
                f"inner {PENCIL_INNER}), {out['engine']}: {it} iterations, "
                f"{out['op_applications']} panels (rule {rule}), largest audible error "
                f"{out['max_rel_err']:.3e} against scipy, rigid eigenvalues "
                f"{' '.join(f'{v:.3e}' for v in rigid)}, engine {out['engine_s']:.3f} s, "
                f"scipy {out['scipy_s']:.2f} s ({card})")
            assert out["op_applications"] == rule, (out["op_applications"], rule)
            assert out["max_rel_err"] < PENCIL_PARITY, out["max_rel_err"]
            assert (rigid != 0).any() and np.abs(rigid).max() < 1e-6 * first, rigid
            rows.append(out)
    return rows


def pencil_routing_check(device, card: str) -> dict:
    """p2: tests/test_amg.py's routing call on the bench box's pencil with small_n=0:
    lambdas over op_state=ElementOperators with kmat_pc/mmat_pc (float32 sparse copies of
    the pencil) and the AMG goes to the element form, so its eigenvalues and vectors equal
    lobpcg_pencil(ops, nev, precond=amg)'s bit for bit on the card (both solves answered by
    the device engine, none by the closure engine)."""
    import torch

    from mesheditor_tpu_torch.scripts.check_eigensolver import f32_pencil
    from mesheditor_tpu_torch.solve.lobpcg import lobpcg_pencil

    box = bench_box_pencil(device)
    ops, cfg, nev = box["ops"], box["cfg"], box["nev"]
    kmat_pc, mmat_pc = f32_pencil(ops)
    kw = dict(sigma=box["sigma"], precond=box["pre"], guard=cfg.guard, tol=cfg.tolerance,
              max_iters=cfg.max_restarts, inner_iters=cfg.inner_iters, small_n=0,
              host_fallback_n=cfg.host_fallback_n, tol_accept=cfg.tol_accept)
    before, closure_before = solve_paths(), closure_solves()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    element = lobpcg_pencil(ops, nev, **kw)
    torch.cuda.synchronize()
    element_s = time.perf_counter() - t0
    routed = lobpcg_pencil(lambda o, x: o.kmat(x), lambda o, x: o.mmat(x), box["kd"],
                           box["md"], ops.n_dofs, nev, op_state=ops, kmat_pc=kmat_pc,
                           mmat_pc=mmat_pc, **kw)
    torch.cuda.synchronize()
    routed_s = time.perf_counter() - t0 - element_s
    after = solve_paths()
    assert (after[0] - before[0], after[1] - before[1]) == (2, 0), (before, after)
    assert closure_solves() == closure_before, "the routing call reached the closure engine"
    assert routed.eigenvalues.size == nev and routed.exit == element.exit
    assert np.array_equal(routed.eigenvalues, element.eigenvalues), \
        f"eigenvalues differ by {np.abs(routed.eigenvalues - element.eigenvalues).max():.3e}"
    assert torch.equal(routed.eigenvectors, element.eigenvectors), \
        f"vectors differ by {(routed.eigenvectors - element.eigenvectors).abs().max():.3e}"
    log(f"[pencil] p2 bench box ({ops.n_dofs} dofs, {nev} pairs, small_n=0): the callable "
        f"form with op_state and kmat_pc routed to the element form, exit {routed.exit}, "
        f"{routed.iterations} iterations; eigenvalues and vectors bit-identical to "
        f"lobpcg_pencil(ops, nev, precond=amg); element form {element_s:.3f} s, routed "
        f"{routed_s:.3f} s ({card})")
    return {"iterations": routed.iterations, "exit": routed.exit, "element_s": element_s,
            "routed_s": routed_s}


def pencil_shells_check(device, card: str, full: bool = False, oracles=None) -> list:
    """p3, a record and not a gate: the thin walls of TRACED_SHELLS (the noisy bowl only
    with `full`) meshed as phase n meshes them, and their pencils solved by the closure
    engine (Jacobi CG, inner 24, tol 1e-8, at most 200 iterations) with the `[eig]` trace
    on, for the same pairs as phase n's engine (6 rigid + the shell's count). Printed:
    iterations, the settled count and the blocker's rel on the trace's first and last
    lines, the answer or "empty", the answer against phase n's scipy oracle where
    `oracles` ({shell: (dofs, audible Hz)}) has one (on the same mesh), and the wall. An
    empty answer after the whole budget is the reference's contract; a CUDA error, a NaN in
    the trace or a run past its budget fails."""
    import torch

    from mesheditor_tpu_torch.fem import (assemble_element_matrices, build_quad_mesh,
                                          filter_degenerate, pencil_diagonals)
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.mesh.cdt import generate_tets_delaunay
    from mesheditor_tpu_torch.scripts.check_eigensolver import op_rule
    from mesheditor_tpu_torch.solve.lobpcg import lobpcg_pencil

    sigma = -((2 * np.pi * 20.0) ** 2)
    rows = []
    for name, surface, nev in thin_shells(full):
        if name not in TRACED_SHELLS:
            continue
        tm = generate_tets_delaunay(*surface())
        kept = filter_degenerate(tm.points, tm.tets)
        quad = build_quad_mesh(kept, tm.points.shape[0])
        ops = assemble_element_matrices(tm.points, kept, CERAMIC.properties, quad,
                                        device=device)
        kd, md = pencil_diagonals(ops)
        pairs = nev + 6
        before, closure_before = solve_paths(), closure_solves()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eig_trace() as lines:
            res = lobpcg_pencil(ops.kmat, ops.mmat, kd, md, ops.n_dofs, pairs, sigma=sigma,
                                tol=PENCIL_TOL, max_iters=PENCIL_BUDGET,
                                inner_iters=PENCIL_INNER)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fields = [CLOSURE_TRACE.match(line) for line in lines]
        assert lines and all(fields), f"{name}: trace lines {lines[:2]}"
        assert not any("nan" in line for line in lines), f"{name}: NaN in the trace"
        assert res.iterations <= PENCIL_BUDGET and len(lines) == res.iterations, \
            (res.iterations, len(lines))
        answered = res.eigenvalues.size > 0
        assert answered or res.iterations == PENCIL_BUDGET, \
            f"{name}: empty after {res.iterations} of {PENCIL_BUDGET} iterations"
        assert solve_paths() == before
        assert closure_solves() == closure_before + answered
        rule = op_rule(res.iterations, PENCIL_INNER, res.iterations // 25)
        assert res.op_applications == rule, (res.op_applications, rule)
        for line in lines if len(lines) <= 6 else lines[:3] + ["..."] + lines[-3:]:
            log(f"[pencil] p3 {name} | {line}")
        row = {"shell": name, "dofs": ops.n_dofs, "pairs": pairs, "iterations": res.iterations,
               "first": (fields[0][2], fields[0][6]), "last": (fields[-1][2], fields[-1][6]),
               "answered": answered, "wall_s": wall, "max_rel_err": None}
        answer = "empty (the budget spent)"
        if answered:
            f = np.sqrt(np.maximum(res.eigenvalues, 0)) / (2 * np.pi)
            f = f[f > 20.0]
            answer = f"{f.size} audible modes, f1 {f[0]:.2f} Hz"
            dofs, oracle = (oracles or {}).get(name, (None, None))
            if oracle is not None:
                assert dofs == ops.n_dofs, f"{name}: {ops.n_dofs} dofs, phase n's {dofs}"
                k = min(f.size, len(oracle), nev - 6)
                row["max_rel_err"] = float((np.abs(f[:k] - oracle[:k]) / oracle[:k]).max())
                answer += f", lowest {k} within {row['max_rel_err']:.3e} of phase n's scipy"
            else:
                answer += ", no oracle in this run"
        log(f"[pencil] p3 {name} ({ops.n_dofs} dofs, {pairs} pairs) through the closure "
            f"engine, Jacobi, inner {PENCIL_INNER}: {res.iterations} iterations, settled "
            f"{row['first'][0]}/{pairs} (blocker rel {row['first'][1]}) at the first line, "
            f"{row['last'][0]}/{pairs} (rel {row['last'][1]}) at the last; {answer}; "
            f"{wall:.3f} s ({card})")
        rows.append(row)
    return rows


def shell_oracles(rows) -> dict:
    """{shell: (dofs, audible Hz of its scipy oracle)} of phase n's shell rows that have
    one (a shell whose solve returned nothing has none)."""
    return {r["shell"]: (r["dofs"], np.asarray(r["oracle_hz"])) for r in rows
            if r.get("oracle_hz")}


def pencil_phase(device, card: str, full: bool = False, shells=None) -> dict:
    """Phase p: p1 (the reference's check_eigensolver on two bars, both preconditioner
    variants), p2 (the callable form routed to the element form, bit for bit) and p3 (the
    thin walls through the closure engine; phase n's shell rows, when given, lend their
    oracles)."""
    t_phase = time.perf_counter()
    out = {"p1": pencil_bars_check(device, card), "p2": pencil_routing_check(device, card),
           "p3": pencil_shells_check(device, card, full, shell_oracles(shells or ()))}
    log(f"[pencil] phase p in {time.perf_counter() - t_phase:.1f} s ({card})")
    return out


def run(stack: contextlib.ExitStack) -> int:
    """The phases, as the command line picks them; temporary directories that outlive a
    phase are entered on `stack`."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--kernels", action="store_true",
                      help="only the kernels against their plain versions, and their times")
    only.add_argument("--scene", action="store_true",
                      help="only the scene-in / audio-out phases (surface, store_batch, "
                           "scene, cli)")
    only.add_argument("--render", action="store_true",
                      help="only the render layer (goldens, full width, times, turntable, "
                           "view and record)")
    only.add_argument("--files", action="store_true",
                      help="only the build and the files phase (glTF round trip and "
                           "playback, simulate/view/record/sessions on a .glb, RealImpact)")
    only.add_argument("--viewer", action="store_true",
                      help="only the build and the viewer phase (the edit command's frames, "
                           "picks, gizmo and strike, in process and as a server)")
    only.add_argument("--multichip", action="store_true",
                      help="only the build and the multi-device phase (NCCL over every "
                           "card, then two ranks sharing a card under gloo)")
    only.add_argument("--bench", action="store_true",
                      help="only the build and the bench phase (the bench command, "
                           "render_bench, edit_loop_bench, cdt_bench, realimpact_batch)")
    only.add_argument("--debug", action="store_true",
                      help="only the build and the debug phase (render_block's kernel and "
                           "debug routes, the eigensolver trace's cost, diag_cdt_solve)")
    only.add_argument("--scans", action="store_true",
                      help="only the build and the scans phase, with the noisy bowl and the "
                           "ellipsoid shell (mesher snapshot, thin shells and bars against "
                           "their oracles, the RealImpact harness on a scan double), after "
                           "both thin walls through the closure engine (p3)")
    only.add_argument("--pencil", action="store_true",
                      help="only the build and the general-pencil phase (the reference's "
                           "check_eigensolver, the routing call, the 2.5%%-wall bowl through "
                           "the closure engine)")
    args = parser.parse_args()
    t_start = time.perf_counter()

    def wall(label: str) -> None:
        log(f"[wall] {label} at {time.perf_counter() - t_start:.1f} s")
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
    from mesheditor_tpu_torch._device import card_label

    card = card_label(torch.device("cuda", 0))
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    if args.render:
        render_phase(device, card)
        log("render: ok")
        return 0

    # 2. build
    from mesheditor_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_kernels()
    log(f"[build] kernel library ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS:.2f} s) at {_build.library_path().relative_to(REPO)}")
    for line in ptxas_summary(_build.BUILD_LOG):
        log(f"[build] {line}")
    t0 = time.perf_counter()
    _build.load_tetmesher()
    log(f"[build] tet mesher ready in {time.perf_counter() - t0:.2f} s at "
        f"{_build.mesher_path().relative_to(REPO)}")

    if args.scene:
        surface_phase(device, card)
        store_batch_phase(device, card)
        scene_phase(device, card)
        cli_phase()
        log("scene: ok")
        return 0
    if args.files:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_scene_") as store:
            files_phase(device, card, store)
        log("files: ok")
        return 0
    if args.viewer:
        viewer_phase(device, card)
        log("viewer: ok")
        return 0
    if args.multichip:
        multichip_phase(device, card)
        log("multichip: ok")
        return 0
    if args.bench:
        bench_phase(device, card)
        log(f"[timing] whole script {time.perf_counter() - t_start:.1f} s ({card})")
        log("bench: ok")
        return 0
    if args.debug:
        debug_phase(device, card)
        log(f"[timing] whole script {time.perf_counter() - t_start:.1f} s ({card})")
        log("debug: ok")
        return 0
    if args.scans:
        # p3 first: phase n's noisy bowl returns no modes and fails its 0.1% bar
        pencil_shells_check(device, card, full=True)
        scans_phase(device, card, full=True)
        log(f"[timing] whole script {time.perf_counter() - t_start:.1f} s ({card})")
        log("scans: ok")
        return 0
    if args.pencil:
        pencil_phase(device, card)
        log(f"[timing] whole script {time.perf_counter() - t_start:.1f} s ({card})")
        log("pencil: ok")
        return 0

    wall("build done")
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
    log(f"[kernel] impact_resonator device {bench_stats['ms']:.4f} ms (events), wrapper "
        f"{bench_stats['wrapper_host_ms']:.4f} ms (host clock), plain "
        f"{bench_stats['plain_ms']:.3f} ms at 64x256, S=16384 ({card})")
    strike_stats = check_strike_kernel(card)

    if args.kernels:
        coupled_kernel_phase(card)
        log("kernels: ok")
        return 0

    wall("phase 3 done")
    # 4. golden render
    from mesheditor_tpu_torch import bench

    rms = bench._golden_render_rms(48_000.0, device)
    band = bench.RMS_BAND
    assert band[0] <= rms <= band[1], f"golden rms {rms:.4e} outside {band}"
    log(f"[golden] render rms {rms:.6e} inside {band}")

    # 5-6. the main path, with every count reset just before it
    from mesheditor_tpu_torch import mesh2modes
    from mesheditor_tpu_torch.materials import CERAMIC
    from mesheditor_tpu_torch.solve import lobpcg

    mesh, cfg, excite = bench.bench_box()
    impact.LAUNCHES = 0
    lobpcg.DEVICE_SOLVES = lobpcg.HOST_SOLVES = 0

    t0 = time.perf_counter()
    with solve_log("[solve] warm-up", card):
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
        f"{lobpcg.DEVICE_SOLVES} (by exit {lobpcg.DEVICE_EXITS}), host solves "
        f"{lobpcg.HOST_SOLVES}")

    t0 = time.perf_counter()
    audio = bench.render_main(result, device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = impact.LAUNCHES
    n_calls = -(-48_128 // 16_384)
    assert audio.shape == (48_128,) and np.isfinite(audio).all(), "render not finite"
    assert np.abs(audio).max() > 0, "render silent"
    assert launches == n_calls, f"kernel launches {launches} != fused calls {n_calls}"
    log(f"[render] 64 objects x 1 s: rms {float(np.sqrt((audio ** 2).mean())):.6e}, "
        f"kernel launches {launches}")

    # Independent oracle: host shift-invert on the same assembled pencil, in a process of
    # its own beside phases a and b (their device times are CUDA events; the host is idle
    # for most of them), after the timed solve and render
    oracle_dir = Path(stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_")))
    oracle, oracle_out = start_oracle(mesh, 26, -((2 * np.pi * cfg.min_mode_freq) ** 2),
                                      oracle_dir)
    stack.callback(oracle.kill)

    wall("phases 4-6 done")
    # (a) coupled kernel vs plain on the card
    from mesheditor_tpu_torch.synth import coupled

    coupled_t = coupled_kernel_phase(card)

    # (b) rest silence through the coupled kernel
    before = coupled.LAUNCHES
    peak = rest_silence(device)
    assert coupled.LAUNCHES == before + 8, "rest scene did not go through the kernel"
    assert peak == 0.0, f"resting contact not silent: peak {peak!r}"
    log("[rest] 8 blocks of 512 with a resting contact: peak exactly 0.0")

    text, err = oracle.communicate(timeout=900)
    assert oracle.returncode == 0, f"the scipy oracle exited {oracle.returncode}:\n{err}"
    ref = np.load(oracle_out)
    rel_f = np.abs(np.sqrt(result.summary.eigenvalues[6:26]) / np.sqrt(ref[6:26]) - 1.0)
    assert rel_f.max() < 1e-5, f"lowest 20 elastic modes off scipy by {rel_f.max():.3e}"
    log(f"[oracle] scipy eigsh {float(text.split()[-1]):.1f} s in a process of its own: lowest "
        f"20 elastic frequencies within {rel_f.max():.3e} relative")

    # (c) the sustained main path: 64 objects, 16 bridge voices, 1 s in 512-sample blocks
    synth, voices = sustained_scene(result, device)
    assert len(voices) == 16, f"bridge resolved {len(voices)} voices, not 16"
    impact.LAUNCHES = coupled.LAUNCHES = 0
    t0 = time.perf_counter()
    sustained, walls = sustained_render(synth, voices)
    sustained_s = time.perf_counter() - t0
    coupled_launches, impact_during = coupled.LAUNCHES, impact.LAUNCHES
    rows = sorted(synth._voice_ids.values())
    ages = synth.voices.age[rows].cpu().numpy()
    assert coupled_launches == 94, f"coupled launches {coupled_launches} != 94 blocks"
    assert impact_during == 0, f"{impact_during} impact-kernel launches on the sustained path"
    assert sustained.shape == (48_128,) and np.isfinite(sustained).all(), "sustained not finite"
    assert np.abs(sustained).max() > 0, "sustained render silent"
    assert len(rows) == 16 and (ages == 48_128).all(), f"voice ages {ages}"
    plain_synth, _ = sustained_scene(result, device)
    impact_only, _ = sustained_render(plain_synth, [])
    diff = float(np.abs(sustained - impact_only).max())
    assert diff > 1e-3 * float(np.abs(impact_only).max()), "the voices are not audible"
    block_median, block_max = float(np.median(walls)), float(np.max(walls))
    log(f"[sustained] 64 objects, 16 voices, 94 blocks of 512: rms "
        f"{float(np.sqrt((sustained ** 2).mean())):.6e}, coupled launches {coupled_launches}, "
        f"impact launches {impact_during}, voice ages {int(ages[0])}, max |sustained - "
        f"impact-only| {diff:.3e} (impact-only peak {float(np.abs(impact_only).max()):.3e})")
    log(f"[sustained] per-block wall median {block_median:.3f} ms, largest {block_max:.3f} ms "
        f"against the 10.667 ms deadline of a 512-sample block; 1 s in {sustained_s:.3f} s "
        f"({card})")

    prof = profile_sustained(result, device)
    if prof["idle_share"] is None:
        log("[profile] the profiler saw no device time: breakdown not measured")
    else:
        log(f"[profile] sustained frame loop ({card}): " + json.dumps(prof))

    wall("phases a-c done")
    # (e)-(h) the scene-in / audio-out path; phase g's store serves phase j
    surface_phase(device, card)
    store_batch_phase(device, card)
    scene_store = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_scene_"))
    scene = scene_phase(device, card, store=scene_store)
    scene_kernels = scene["kernels"]
    cli_phase()

    wall("phases e-h done")
    # (i) the render layer: no kernel of its own, and it launches neither resonator kernel
    # (timed 3 times a chunk here, 5 with --render, to keep the whole run in its time)
    impact.LAUNCHES = coupled.LAUNCHES = 0
    render_phase(device, card, timing_reps=3)
    assert impact.LAUNCHES == coupled.LAUNCHES == 0, "the render launched a resonator kernel"

    wall("phase i done")
    # (j) files: glTF in and out, the commands on a .glb, sessions, RealImpact (the counts
    # are set to 0 at its start and read at its end)
    files_kernels = files_phase(device, card, scene_store, scene["bodies"])
    assert all(files_kernels[k]["launches"] > 0 for k in files_kernels), files_kernels

    wall("phase j done")
    # (k) the viewer: the edit command's repaint, picks, gizmo and strike (the counts are
    # set to 0 just before the strike and read just after it)
    viewer_kernels = viewer_phase(device, card)

    wall("phase k done")
    # (l) the multi-device layer: the counts are set to 0 in every rank just before each
    # sharded render and read just after it
    multichip = multichip_phase(device, card, result)

    wall("phase l done")
    # (m) the bench command and the bench tools: the counts are set to 0 just before each
    # of render_bench's runs and read just after it (m1's come from its own process)
    m = bench_phase(device, card)
    m2 = m["m2"]

    wall("phase m done")
    # (n) the scanned-object regime: the harness's counts come from its own process, which
    # starts at 0
    scans = scans_phase(device, card)

    wall("phase n done")
    # (o) the debugging surface: o1's kernel-route launches are counted apart (o3 ran in
    # phase n)
    debug = debug_phase(device, card, result)

    wall("phase o done")
    # (p) the general-pencil form: the closure engine launches no kernel; phase n's thin
    # shells lend their oracles to p3
    impact.LAUNCHES = coupled.LAUNCHES = 0
    pencil_phase(device, card, shells=scans["shells"])
    assert impact.LAUNCHES == coupled.LAUNCHES == 0, "the eigensolves launched a kernel"

    wall("phase p done")
    # timings
    log(f"[timing] solve_s {solve_s:.3f} render_s {render_s:.3f} sustained_block_median_ms "
        f"{block_median:.3f} ({card})")
    imp_bound, imp_by = bound(*impact_flops_bytes(64, 256, 1, 16384))
    c512 = coupled_t["main-path layout", 512]
    log(json.dumps({"kernels": [{
        "name": "impact_resonator", "route": "cuda",
        "source": "mesheditor_tpu_torch/csrc/impact_resonator.cu",
        "replaces": "mesheditor_tpu/synth/pallas_impact.py:48",
        "launches": launches, "scene_launches": scene_kernels["impact"]["launches"],
        "files_launches": files_kernels["impact"]["launches"],
        "files_blocks": files_kernels["impact"]["blocks"],
        "files_max_abs_err": files_kernels["impact"]["max_abs_err"],
        "files_max_rel_err": files_kernels["impact"]["max_rel_err"],
        "viewer_launches": viewer_kernels["impact"]["launches"],
        "viewer_blocks": viewer_kernels["impact"]["blocks"],
        "viewer_max_abs_err": viewer_kernels["impact"]["max_abs_err"],
        "viewer_max_rel_err": viewer_kernels["impact"]["max_rel_err"],
        "scene_max_abs_err": scene_kernels["impact"]["max_abs_err"],
        "scene_max_rel_err": scene_kernels["impact"]["max_rel_err"],
        "multichip_launches": multichip["impact"][0],
        "multichip_max_rel_err": multichip["impact"][1],
        "bench_launches": m["m1"]["launches"], "bench_kernel_parity": m["m1"]["kernel_parity"],
        "render_bench_launches": m2["launches"]["impact"],
        "render_bench_blocks_checked": m2["checked"]["impact"]["blocks"],
        "render_bench_max_rel_err": m2["checked"]["impact"]["max_rel_err"],
        "render_bench_widest": m2["widest"]["impact"],
        "scans_launches": scans["harness"]["launches"],
        "scans_blocks_checked": scans["harness"]["checked"]["blocks"],
        "scans_max_rel_err": scans["harness"]["checked"]["max_rel_err"],
        "debug_launches": debug["o1"]["impact_launches"],
        "max_abs_err": bench_stats["max_abs_err"],
        "ms": bench_stats["ms"], "plain_ms": bench_stats["plain_ms"],
        "bound_ms": imp_bound, "bound_by": imp_by, "library_ms": None,
    }, {
        "name": "coupled_resonator", "route": "cuda",
        "source": "mesheditor_tpu_torch/csrc/coupled_resonator.cu",
        "replaces": "mesheditor_tpu/synth/pallas_coupled.py:40",
        "launches": coupled_launches, "scene_launches": scene_kernels["coupled"]["launches"],
        "files_launches": files_kernels["coupled"]["launches"],
        "files_blocks": files_kernels["coupled"]["blocks"],
        "files_max_abs_err": files_kernels["coupled"]["max_abs_err"],
        "files_max_rel_err": files_kernels["coupled"]["max_rel_err"],
        "viewer_launches": viewer_kernels["coupled"]["launches"],
        "scene_max_abs_err": scene_kernels["coupled"]["max_abs_err"],
        "scene_max_rel_err": scene_kernels["coupled"]["max_rel_err"],
        "multichip_launches": multichip["coupled"][0],
        "multichip_max_rel_err": multichip["coupled"][1],
        "render_bench_launches": m2["launches"]["coupled"],
        "render_bench_blocks_checked": m2["checked"]["coupled"]["blocks"],
        "render_bench_max_rel_err": m2["checked"]["coupled"]["max_rel_err"],
        "render_bench_widest": m2["widest"]["coupled"],
        "debug_launches": debug["o1"]["launches"],
        "debug_max_rel_err": debug["o1"]["max_rel_err"],
        "max_abs_err": c512["max_abs_err"],
        "ms": c512["ms"], "plain_ms": c512["plain_ms"],
        "bound_ms": c512["bound_ms"], "bound_by": c512["bound_by"], "library_ms": None,
    }, {
        "name": "strike_precompute", "route": "cuda",
        "source": "mesheditor_tpu_torch/csrc/strike_precompute.cu", "replaces": None,
        "ms": strike_stats["ms"], "plain_ms": strike_stats["plain_ms"],
        "bound_ms": strike_stats["bound_ms"], "bound_by": strike_stats["bound_by"],
        "library_ms": None,
    }]}))
    log(f"[timing] whole script {time.perf_counter() - t_start:.1f} s ({card})")
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    with contextlib.ExitStack() as stack:
        return run(stack)


if __name__ == "__main__":
    sys.exit(main())
