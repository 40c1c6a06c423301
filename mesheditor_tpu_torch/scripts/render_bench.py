"""Render benchmark: us/block and realtime-x against the 512-sample @ 48 kHz deadline
(counterpart of scripts/render_bench.py).

The analog of the reference's ModalRenderBench (tests/ModalRenderBench.cpp:165-205): cases
sweep objects x modes x voices x impacts; each reports steady-state microseconds per
512-sample block and the realtime factor against the 10667 us deadline. A fused variant
(one call of all the blocks' samples) shows the streaming headroom when no per-block host
interaction is needed. Voice-free blocks go through the impact kernel, blocks with a live
voice through the coupled kernel; each case's launches of both over its timed stretch are
printed beside its time.

Usage: python -m mesheditor_tpu_torch.scripts.render_bench [--fused] [--blocks N]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..synth import ContactTrackSpec, ModalEvent, ModalSynth, SustainedVoice, coupled, impact
from ..synth.tracks import synthesize_roughness
from ..types import ModalModes

SR = 48_000.0
BLOCK = 512
DEADLINE_US = BLOCK / SR * 1e6

# (objects, modes, voices, impacts): the full reference envelope
# (ModalRenderBench.cpp:165-196), including the voice-heavy tail: 256 voices on one object
# (the coupled kernel's own scaling) and 256 objects x 1 voice (the shape a scene has).
CASES = (
    (1, 64, 0, 1),
    (1, 64, 1, 1),
    (1, 64, 4, 0),
    (1, 200, 0, 1),
    (1, 200, 0, 4),
    (1, 200, 1, 1),
    (1, 200, 4, 0),
    (1, 512, 0, 4),
    (1, 512, 1, 0),
    (1, 512, 4, 0),
    (1, 200, 16, 0),
    (1, 200, 64, 0),
    (1, 200, 256, 0),
    (16, 200, 16, 0),
    (64, 200, 64, 0),
    (256, 200, 256, 0),
    (64, 200, 0, 64),
    (256, 200, 0, 256),
    (256, 200, 16, 0),  # 256 objects, 16 ringing with voices
    (256, 64, 16, 64),
    (1024, 64, 0, 16),  # 1024 objects, 16 ringing
)


def make_modes(k: int) -> ModalModes:
    rng = np.random.default_rng(7)
    freqs = np.linspace(60, 12000, k)
    return ModalModes(
        freqs=freqs,
        t60s=2.0 / np.arange(1, k + 1) ** 0.5,
        shapes=(rng.standard_normal((4, k, 3)) * 0.01).astype(np.float32),
        positions=np.zeros((4, 3), np.float32),
    )


def enqueue_impacts(synth: ModalSynth, n_objects: int, n_impacts: int) -> None:
    """The case's strikes: impact i on object i mod n_objects, a 2,000-sample pulse."""
    for i in range(n_impacts):
        synth.enqueue(ModalEvent("impact", obj=i % n_objects, expos=0, j=(0.05, 0.02, 0),
                                 pulse_step=1 / 2000.0, pulse_gamma=np.pi / 2 / 2000.0))


def scene(n_objects, n_modes, n_voices, n_impacts, device="cuda"):
    """A case's synth on `device` with its impacts queued, and its voice set (published
    before every block). Voice v slides on object v mod n_objects over one surface track."""
    synth = ModalSynth([make_modes(n_modes)] * n_objects, gains=[1.0] * n_objects,
                       max_impacts=max(n_impacts, 8), max_voices=max(n_voices, 1),
                       device=device)
    slot = synth.adopt_track(1, lambda: synthesize_roughness(1e-4, -2.0, 1e-6))
    enqueue_impacts(synth, n_objects, n_impacts)
    voices = [
        SustainedVoice(
            voice_id=v + 1, obj=v % n_objects, blend_points=(0, 1, 2),
            blend_weights=(0.5, 0.3, 0.2), normal=(0, 1, 0), slip_dir=(1, 0, 0),
            sweep_dir=((1, 0, 0), (0, 0, -1)), normal_force=4.0, friction=0.4,
            stiffness=2.0**28, static_penetration=2.0**-20, damping_coeff=0.3,
            tracks=tuple(ContactTrackSpec(slot, 0.4, 2e-7, 8.0, 4e-7) for _ in range(4)),
        )
        for v in range(n_voices)
    ]
    return synth, voices


def case(n_objects, n_modes, n_voices, n_impacts, blocks, fused, device="cuda") -> dict:
    """One case: warm at the timed call size, then `blocks` blocks timed. Returns its
    us/block, realtime factor, the kernels' launches over the timed stretch and whether
    every sample of that stretch is finite."""
    synth, voices = scene(n_objects, n_modes, n_voices, n_impacts, device)
    # Voice cases stream block-wise (the frame loop republishes each block and the idle
    # timeout would end a voice inside a long fused call), so fusing applies to impact-only
    # scenes. Warming at the exact timed call size keeps first-call costs out of the time.
    fused = fused and not voices
    n = blocks * BLOCK
    if fused:
        synth.render(n).cpu()  # warm at size
        enqueue_impacts(synth, n_objects, n_impacts)
        launches = impact.LAUNCHES, coupled.LAUNCHES
        t0 = time.perf_counter()
        outs = [synth.render(n)]
        outs[-1].cpu()
        wall = time.perf_counter() - t0
    else:
        if voices:
            synth.publish_voices(voices)
        synth.render(BLOCK).cpu()  # warm at size
        launches = impact.LAUNCHES, coupled.LAUNCHES
        t0 = time.perf_counter()
        outs = []
        for _ in range(blocks):
            if voices:
                synth.publish_voices(voices)
            outs.append(synth.render(BLOCK))
        outs[-1].cpu()  # the host copy of the last block ends the timed stretch
        wall = time.perf_counter() - t0
    us_per_block = wall / blocks * 1e6
    return {
        "us_per_block": us_per_block, "realtime_x": DEADLINE_US / us_per_block,
        "impact_launches": impact.LAUNCHES - launches[0],
        "coupled_launches": coupled.LAUNCHES - launches[1],
        "finite": bool(torch.isfinite(torch.cat(outs)).all()),
    }


def main(argv=None) -> list:
    from .._device import card_label, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"{'objects':>8} {'modes':>6} {'voices':>7} {'impacts':>8} {'us/block':>10} "
          f"{'realtime x':>11} {'impact':>7} {'coupled':>8} {'finite':>7}", flush=True)
    rows = []
    for o, k, v, i in CASES:
        r = case(o, k, v, i, args.blocks, args.fused, device)
        rows.append({"case": (o, k, v, i), **r})
        print(f"{o:>8} {k:>6} {v:>7} {i:>8} {r['us_per_block']:>10.1f} "
              f"{r['realtime_x']:>11.2f} {r['impact_launches']:>7} "
              f"{r['coupled_launches']:>8} {str(r['finite']):>7}", flush=True)
    print(f"(impact / coupled: kernel launches over the timed blocks; {args.blocks} blocks"
          f"{', fused' if args.fused else ''}) on {card_label(device)}", flush=True)
    return rows


if __name__ == "__main__":
    main()
