"""Loop kind `play`: a frame loop over one synth of the configuration's objects. Each frame
enqueues the strikes due in its block (a Poisson stream drawn from the seed on the audio
clock), publishes the sustained voices (when the mix has contacts), renders one block and
brings it to the host; the next frame starts when that copy is back (a closed loop).

Set-up makes the modal bank from the seed, the synth through `api.make_synth`, resolves the
contacts into voices through the program's `AudioContactBridge`, and warms the same calls
on a second synth of its own, so the window's synth starts from rest.

The check: the reference renders the window's first blocks from rest on its own state, and
a few later blocks drawn from the seed from the program's state before each (the only way
to reach block 1,000 without rendering 999 before it); each block's samples and the state
after it are compared, and the voices' constants against the reference's own.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import inputs
from portbench.harness import Check, Run
from portbench.reference import bridge as ref_bridge
from portbench.reference import compare
from portbench.reference import synth as ref_synth
from portbench.window import closed_loop, memory_peak


def _snapshot(synth) -> dict:
    """The program's carried state: the bank's (O, K) state and, by voice object, the
    voices' relief-mean and penetration carries."""
    v = synth.voices
    active = v.active.cpu().numpy()
    objs = v.obj.cpu().numpy()
    rm, pen = v.relief_mean.cpu().numpy(), v.penetration.cpu().numpy()
    return {"z_re": synth.state.z_re.cpu().numpy(), "z_im": synth.state.z_im.cpu().numpy(),
            "carries": {int(objs[r]): (float(rm[r]), float(pen[r]))
                        for r in np.flatnonzero(active)}}


def run(ctx):
    import torch

    from mesheditor_tpu_torch import _build
    from mesheditor_tpu_torch.api import make_synth
    from mesheditor_tpu_torch.physics import AudioContactBridge, SustainedContact
    from mesheditor_tpu_torch.physics.bridge import AudioBody, ContactSurface
    from mesheditor_tpu_torch.synth.contact import ContactDynamics
    from mesheditor_tpu_torch.types import AcousticMaterialProperties, ModalModes

    cfg, tr, seed, dev = ctx.config, ctx.traffic, ctx.seed, ctx.device
    play, mat = cfg["play"], {k: float(v) for k, v in cfg["material"].items() if k != "name"}
    sr, n = float(play["sample_rate"]), int(play["block"])
    material = AcousticMaterialProperties(mat["density"], mat["young"], mat["poisson"],
                                          mat["alpha"], mat["beta"])
    if dev == "cuda":
        _build.load_kernels()
    bank = inputs.modal_bank(seed, play, mat)
    models = [ModalModes(f, t, s, positions=p.astype(np.float32)) for f, t, s, p in bank]
    mass, inv_inertia, com = inputs.box_dynamics(play, mat)
    surfaces = [tuple(s) for s in tr.get("surfaces", [])]
    contacts = inputs.contacts(seed, tr, lambda o: bank[o][3])

    def surface_of(obj):
        return surfaces[obj % len(surfaces)]

    def make():
        synth = make_synth(models, sample_rate=sr, modal_level=play["modal_level"], device=dev)
        if not contacts:
            return synth, []
        br = AudioContactBridge(synth)
        for o, (_f, _t, _s, pos) in enumerate(bank):
            sig, corr, slope, spacing = surface_of(o)
            br.register(o, AudioBody(o, ContactDynamics(mass, inv_inertia, pos - com), material,
                                     pos, ContactSurface(sig, corr, slope, spacing)))
        sustained = {c["contact_id"]: SustainedContact(**c) for c in contacts}
        return synth, br.resolve_voices(sustained, sr)

    def strikes(b):
        return inputs.strikes_in_block(seed, b, tr, play["objects"], play["positions"], n, sr)

    def frame(synth, voices, due):
        for s in due:
            synth.strike(*s)
        if voices:
            synth.publish_voices(voices)
        return synth.render(n).cpu().numpy()

    # Warm-up: the same calls on a synth of its own, on strikes no window block gets.
    warm, warm_voices = make()
    for b in range(tr["warm_blocks"]):
        frame(warm, warm_voices, strikes(-1 - b))
    del warm
    if dev == "cuda":
        torch.cuda.synchronize()
    synth, voices = make()
    setup_s = time.perf_counter() - ctx.t_start

    sampler = inputs.rng(seed, inputs.SAMPLE)
    start, p_sample, max_sampled = tr["start_blocks"], tr["sample_every"], tr["sampled_blocks"]
    snaps = {}

    def step(b):
        snap = b < start or (len(snaps) < start + max_sampled and sampler.random() < p_sample)
        before = _snapshot(synth) if snap else None
        due = strikes(b)
        t0 = time.perf_counter()
        with ctx.spans("play/strikes"):
            for s in due:
                synth.strike(*s)
        if voices:
            with ctx.spans("play/publish"):
                synth.publish_voices(voices)
        with ctx.spans("play/render"):
            out = synth.render(n)
        with ctx.spans("play/copy"):
            host = out.cpu().numpy()
        wall = time.perf_counter() - t0
        if snap:
            snaps[b] = (before, _snapshot(synth), host.copy())
        return {"wall": wall, "ok": bool(np.isfinite(host).all()), "strikes": len(due),
                "voices": len(voices)}

    units, window_s, summary = closed_loop(ctx, step, tr["trace_units"])
    peak = memory_peak(dev)
    if summary is not None:
        summary.extra["work"] = [work(b, strikes, play, n, sr, len(voices))
                                 for b in range(summary.units)]
    del synth
    t0 = time.perf_counter()
    checks = reference_checks(tr, play, mat, bank, contacts, surface_of, voices, snaps,
                              strikes, n, sr, torch.float64, ctx.cell_limits)
    print(f"portbench: reference of blocks {sorted(snaps)}: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return Run(units=units, window_s=window_s, setup_s=setup_s, attempted=len(units),
               failed=sum(1 for u in units if not u["ok"]), checks=checks,
               memory_peak_bytes=peak, counters={"checked_blocks": sorted(snaps)},
               trace=summary)


def live_strikes(b, strikes, n, sr, lookback=4):
    """The strikes whose pulse is still under way at the start of block b (a pulse lasts
    at most `lookback` blocks)."""
    out = []
    for e in range(max(0, b - lookback), b + 1):
        for s in strikes(e):
            st = ref_synth.strike_state(s, e, b, n, sr)
            if st is not None:
                out.append(st)
    return out


def work(b, strikes, play, n, sr, n_voices) -> dict:
    """Block b's workload for the rooflines: objects x modes x samples, the live voices,
    and the strike-samples whose pulse drives a mode."""
    live = live_strikes(b, strikes, n, sr)
    drive = sum(min(total - age, n) for *_x, total, _a, age in live)
    return {"objects": play["objects"], "modes": play["modes"], "samples": n,
            "voices": n_voices, "strike_samples": int(drive), "strikes": len(live)}


def voice_checks(program_voices, ref_voices) -> float:
    """The largest relative gap between the program's published voice constants and the
    reference's, field by field over the set."""
    if len(program_voices) != len(ref_voices):
        return float("inf")
    worst = 0.0
    fields = {"stiffness": "stiffness", "static_penetration": "static_pen",
              "damping_coeff": "damping", "normal_force": "normal_force",
              "friction": "friction"}
    for pv, rv in zip(program_voices, ref_voices):
        if pv.voice_id != rv["voice_id"] or pv.obj != rv["obj"] or \
                tuple(pv.blend_points) != (rv["expos"],) * 3:
            return float("inf")
        pairs = [(getattr(pv, a), rv[b]) for a, b in fields.items()]
        pairs += list(zip(pv.normal, rv["normal"])) + list(zip(pv.slip_dir, rv["slip"]))
        pairs += list(zip(np.ravel(pv.sweep_dir), np.ravel(rv["sweep"])))
        for pt, rt in zip(pv.tracks, rv["tracks"]):
            if (pt.index >= 0) != (rt[0] is not None):
                return float("inf")
            pairs += list(zip((pt.rate, pt.sigma, pt.window, pt.step), rt[1:]))
        for a, b in pairs:
            worst = max(worst, abs(a - b) / max(abs(b), 1e-300) if b else abs(a))
    return worst


def reference_checks(tr, play, mat, bank, contacts, surface_of, program_voices, snaps,
                     strikes, n, sr, dtype, limits, round_voices=None) -> list:
    """Render the checked blocks with the reference (in `dtype`) and compare. The first
    `start_blocks` run chained from rest on the reference's own state; each later one from
    the program's state before it."""
    import torch

    ref_voices = ref_bridge.voices(contacts, mat, surface_of, lambda o: bank[o][3], sr)
    if round_voices is not None:
        ref_voices = round_voices(ref_voices)
    tracks = {}
    for v in ref_voices:
        for surf, *_rest in v["tracks"]:
            if surf is not None and surf not in tracks:
                tracks[surf] = ref_bridge.roughness(surf[1], surf[2], surf[3])
    gain = play["modal_level"] / play["modes"] * 1e3
    tab = ref_synth.Tables([b[:3] for b in bank], [gain] * play["objects"], sr, ref_voices,
                           tracks, dtype)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 8))
    block_gap = state_gap = carry_gap = 0.0
    own = None  # the reference's own state through the start blocks
    for b in sorted(snaps):
        before, after, out = snaps[b]
        if b < tr["start_blocks"]:
            if own is None:
                k = tab.n_modes
                own = (np.zeros((tab.n_obj, k)), np.zeros((tab.n_obj, k)), {})
            z_re, z_im, carries = own
        else:
            z_re, z_im = before["z_re"], before["z_im"]
            carries = {v["voice_id"]: before["carries"][v["obj"]] for v in ref_voices} \
                if b > 0 else {}
        r_out, r_re, r_im, r_car = ref_synth.render_block(
            tab, z_re, z_im, live_strikes(b, strikes, n, sr),
            carries, n * b, n)
        if b < tr["start_blocks"]:
            own = (r_re, r_im, r_car)
        block_gap = max(block_gap, compare.rel_gap(out, r_out))
        k = r_re.shape[1]
        pad = np.abs(after["z_re"][:, k:]).max(initial=0) + np.abs(after["z_im"][:, k:]).max(
            initial=0)
        state_gap = max(state_gap, compare.rel_gap(
            np.concatenate([after["z_re"][:, :k], after["z_im"][:, :k]]),
            np.concatenate([r_re, r_im])) + (float("inf") if pad else 0.0))
        if ref_voices:
            got = np.array([after["carries"].get(v["obj"], (np.nan, np.nan)) for v in ref_voices])
            want = np.array([r_car[v["voice_id"]] for v in ref_voices])
            carry_gap = max(carry_gap, compare.rel_gap(got[:, 0], want[:, 0]),
                            compare.rel_gap(got[:, 1], want[:, 1]))
    torch.set_num_threads(threads)
    checks = [Check("block_rel", block_gap, limits["block_rel"]),
              Check("state_rel", state_gap, limits["state_rel"])]
    if ref_voices or program_voices:
        checks.append(Check("carry_rel", carry_gap, limits["carry_rel"]))
        checks.append(Check("voice_rel", voice_checks(program_voices, ref_voices),
                            limits["voice_rel"]))
    return checks


def small(config, traffic):
    """The CPU tests' cut: 4 objects of 24 modes, one warm-up block, strikes at 400/s,
    half the blocks checked, 2 contacts where the mix has them."""
    config["play"].update(objects=4, modes=24)
    traffic.update(warm_blocks=1, trace_units=2, strike_rate=400.0, sample_every=0.5)
    if traffic.get("contacts"):
        traffic["contacts"] = 2
    return config, traffic


def _bf16(x):
    import torch

    return float(torch.tensor(float(x), dtype=torch.bfloat16))


def control(config, traffic, seed, limits, blocks):
    """The bfloat16 render against the float64 one over the first `blocks` blocks, each
    side chained from rest on its own state."""
    from types import SimpleNamespace

    import torch

    play, sr, n = config["play"], float(config["play"]["sample_rate"]), config["play"]["block"]
    mat = {k: float(v) for k, v in config["material"].items() if k != "name"}
    bank = inputs.modal_bank(seed, play, mat)
    surfaces = [tuple(s) for s in traffic.get("surfaces", [])]
    contacts = inputs.contacts(seed, traffic, lambda o: bank[o][3])

    def surface_of(o):
        return surfaces[o % len(surfaces)]

    def strikes(b):
        return inputs.strikes_in_block(seed, b, traffic, play["objects"], play["positions"],
                                       n, sr)

    def round_voices(vs):
        out = []
        for v in vs:
            w = dict(v)
            for key in ("normal_force", "friction", "stiffness", "static_pen", "damping"):
                w[key] = _bf16(v[key])
            for key in ("normal", "slip"):
                w[key] = np.array([_bf16(a) for a in v[key]])
            w["sweep"] = tuple(np.array([_bf16(a) for a in s]) for s in v["sweep"])
            w["tracks"] = [(t[0], *(_bf16(a) for a in t[1:])) for t in v["tracks"]]
            out.append(w)
        return out

    low_voices = round_voices(ref_bridge.voices(contacts, mat, surface_of, lambda o: bank[o][3], sr))
    tracks = {}
    for v in low_voices:
        for surf, *_r in v["tracks"]:
            if surf is not None and surf not in tracks:
                tracks[surf] = ref_bridge.roughness(surf[1], surf[2], surf[3])
    gain = play["modal_level"] / play["modes"] * 1e3
    tab = ref_synth.Tables([b[:3] for b in bank], [gain] * play["objects"], sr, low_voices,
                           tracks, torch.bfloat16)
    k = play["modes"]
    state = (np.zeros((play["objects"], k)), np.zeros((play["objects"], k)), {})
    snaps = {}

    def snap(z_re, z_im, carries):
        return {"z_re": z_re, "z_im": z_im,
                "carries": {v["obj"]: carries[v["voice_id"]] for v in low_voices
                            if v["voice_id"] in carries}}

    for b in range(blocks):
        before = snap(*state)
        out, z_re, z_im, car = ref_synth.render_block(
            tab, state[0], state[1], live_strikes(b, strikes, n, sr), state[2], n * b, n)
        state = (z_re, z_im, car)
        snaps[b] = (before, snap(*state), out)
    program_voices = [SimpleNamespace(
        voice_id=v["voice_id"], obj=v["obj"], blend_points=(v["expos"],) * 3,
        stiffness=v["stiffness"], static_penetration=v["static_pen"], damping_coeff=v["damping"],
        normal_force=v["normal_force"], friction=v["friction"], normal=tuple(v["normal"]),
        slip_dir=tuple(v["slip"]), sweep_dir=v["sweep"],
        tracks=[SimpleNamespace(index=0 if t[0] is not None else -1, rate=t[1], sigma=t[2],
                                window=t[3], step=t[4]) for t in v["tracks"]])
        for v in low_voices]
    tr = dict(traffic, start_blocks=blocks)  # every block chained on the control's own state
    checks = reference_checks(tr, play, mat, bank, contacts, surface_of, program_voices, snaps,
                              strikes, n, sr, torch.float64, limits)
    return {c.name: c.value for c in checks}
