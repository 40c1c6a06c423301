"""The control of each cell's comparison: the plain reference put in the program's place and
computed in the nearest precision below the configuration's (float32 for the solves'
float64; bfloat16 for the render's float32, its voice constants rounded to bfloat16),
compared with the float64 reference by the cell's own numbers. A limit stands only where
the control fails it.

    python3 -m portbench.calibrate --cell box.solve --seeds 11 12 13

prints one JSON line a seed with the control's numbers beside the cell's limits. The
benchmark's own runs never run it; portbench/tests/test_portbench_control.py runs it at a
small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import harness, inputs
from .reference import compare, fem, mesher


def solve_control(config: dict, traffic: dict, kind: str, seed: int, limits: dict) -> dict:
    """The float32 reference against the float64 one on the seed's first window solve."""
    mat = {k: float(v) for k, v in config["material"].items() if k != "name"}
    if kind == "solve":
        mesh = config["mesh"]
        points, tets = inputs.box_tets(mesh["extents"], mesh["resolution"])
        ids = inputs.boundary_vertices(mesh["resolution"])
        n_ex, sv = config["excitation_points"], config["solver"]
        args = (sv["num_modes"], sv["num_fem_modes"], sv.get("min_mode_freq", 20.0),
                sv["max_mode_freq"])
    else:
        s = config["surface"]
        points, tris = inputs.torus_surface(s["major"], s["minor"], s["n_major"], s["n_minor"])
        ids, st = np.arange(len(points)), config["settings"]
        n_ex, nm = st["num_vertices"], st["num_modes"]
        args = (nm, max(nm + 15, nm * 3 // 2), st["min_mode_freq"], st["max_mode_freq"])
    moved, excite = inputs.solve_call(seed, 0, points, ids, n_ex, traffic["rotate"],
                                      traffic["shift_m"])
    if kind == "surface":
        span = float((moved.max(0) - moved.min(0)).max())
        moved, tets = mesher.delaunay(moved, tris, span / config["tet_resolution"])
    ref = fem.solve_modes(moved, tets, mat, excite, *args, np.float64)
    low = fem.solve_modes(moved, tets, mat, excite, *args, np.float32)
    checks = compare.modes_checks({"modes": low, "dofs": low["dofs"]}, ref, limits)
    return {c.name: c.value for c in checks}


def _bf16(x):
    import torch

    return float(torch.tensor(float(x), dtype=torch.bfloat16))


def play_control(config: dict, traffic: dict, seed: int, limits: dict, blocks: int) -> dict:
    """The bfloat16 render against the float64 one over the first `blocks` blocks, each
    side chained from rest on its own state."""
    import torch

    play_mod = harness.load_module("loops", "play")
    from .reference import bridge as ref_bridge
    from .reference import synth as ref_synth

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
            tab, state[0], state[1], play_mod.live_strikes(b, strikes, n, sr), state[2], n * b, n)
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
    checks = play_mod.reference_checks(tr, play, mat, bank, contacts, surface_of,
                                       program_voices, snaps, strikes, n, sr, torch.float64,
                                       limits)
    return {c.name: c.value for c in checks}


def control(cell: str, seed: int, config=None, traffic=None, limits=None, blocks: int = 3):
    spec = harness.load_json("cells", cell)
    config = config or harness.load_json("configs", spec["config"])
    traffic = traffic or harness.load_json("traffic", spec["traffic"])
    limits = limits or spec["limits"]
    if traffic["kind"] == "play":
        return play_control(config, traffic, seed, limits, blocks)
    return solve_control(config, traffic, traffic["kind"], seed, limits)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--blocks", type=int, default=3)
    args = p.parse_args(argv)
    limits = harness.load_json("cells", args.cell)["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control(args.cell, seed, blocks=args.blocks)
        print(json.dumps({"cell": args.cell, "seed": seed, "control": got, "limits": limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
